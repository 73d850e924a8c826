"""The port's LIDC, ISIC, Synapse and Building loaders, its 2-D
augmentations, preflight validators and synthetic trees against the JAX
package's, on the CPU.

Both sides are the same numpy / scipy / Pillow code, so they are held
exactly: bit-equal batches for all nine names ``build_loader`` accepts
(train streams into their second epoch, test and val splits whole), equal
transform outputs on the same seed, the same preflight verdicts and
byte-equal files. The 2-D train transforms draw from one generator that a
loader's threads share (their order decides which sample gets which draw,
in both packages), so every loader here runs one thread. Trees are small:
48^2 images, a dozen or so files.
"""

import filecmp
import os

import numpy as np
import pytest

from hpfg_tpu.config import Config
from hpfg_tpu.data import augment2d as ja
from hpfg_tpu.data import builder as jbuilder
from hpfg_tpu.data import synthetic as jsyn
from hpfg_tpu.data.loader import BatchLoader as JaxBatchLoader
from hpfg_tpu.data.preflight import validate_data_tree as jax_validate
from hpfg_tpu_torch.data import augment2d as ta
from hpfg_tpu_torch.data import builder
from hpfg_tpu_torch.data import synthetic as tsyn
from hpfg_tpu_torch.data.loader import BatchLoader
from hpfg_tpu_torch.data.preflight import (
    DataPreflightError,
    preflight_or_raise,
    validate_data_tree,
)

HW = (48, 48)
#: dataset name -> (tree, ``num_classes``)
NAMES = {"lidc": ("lidc", 2), "sup_lidc": ("lidc", 2), "isic": ("isic", 2),
         "sup_isic": ("isic", 2), "synapse": ("synapse", 9),
         "sup_synapse": ("synapse", 9), "sup_building": ("building", 2),
         "acdc": ("acdc", 4), "sup_acdc": ("acdc", 4)}
#: the JAX package's writer and its arguments for each tree
TREES = {
    "lidc": ("make_synthetic_lidc", dict(n=16, hw=HW)),
    "isic": ("make_synthetic_isic", dict(n=16, hw=HW)),
    "synapse": ("make_synthetic_synapse", dict(n_train=12, n_vols=2, depth=3,
                                               hw=HW)),
    "building": ("make_synthetic_building", dict(n=12, hw=HW)),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory, synthetic_acdc):
    root = tmp_path_factory.mktemp("trees2d")
    out = {"acdc": synthetic_acdc}
    for name, (fn, kw) in TREES.items():
        out[name] = getattr(jsyn, fn)(str(root / name), **kw)
    return out


def _cfg(root, name, **kw):
    base = dict(datasets=name, data_path=root, batch_size=2,
                unlabel_batch_size=3, train_crop_size=[32, 32],
                label_num=0.5, seed=5)
    base.update(kw)
    return Config(base)


def _one_thread(loaders):
    for loader in loaders:
        if isinstance(loader, (BatchLoader, JaxBatchLoader)):
            loader.num_threads = 1
    return loaders


def _assert_batches_equal(got, want):
    (gi, gl), (ri, rl) = got, want
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gl, rl)
    assert gi.dtype == ri.dtype and gl.dtype == rl.dtype


@pytest.mark.parametrize("name", sorted(NAMES))
def test_build_loader_yields_the_jax_batches(trees, name):
    cfg = _cfg(trees[NAMES[name][0]], name)
    got = _one_thread(builder.build_loader(cfg))
    ref = _one_thread(jbuilder.build_loader(cfg))
    assert len(got) == len(ref)
    assert [type(g).__name__ for g in got] == [type(r).__name__ for r in ref]
    n_train = 1 if name.startswith("sup_") else 2
    for g, r in zip(got[:n_train], ref[:n_train]):
        assert len(g) == len(r) > 0
        cg, cr = g.cycle(), r.cycle()
        for _ in range(len(r) + 2):  # into the second epoch
            _assert_batches_equal(next(cg), next(cr))
    for g, r in zip(got[n_train:], ref[n_train:]):  # val and test, whole
        g_items, r_items = list(g), list(r)
        assert len(g_items) == len(r_items) > 0
        for a, b in zip(g_items, r_items):
            _assert_batches_equal(a, b)


def test_building_test_split_is_image_only(trees):
    """The Building test split yields its images with all-zero masks, at
    their own size, its last batch kept (the JAX package's property)."""
    train, val, test = builder.build_loader(
        _cfg(trees["building"], "sup_building"))
    batches = list(test)
    assert [len(b[0]) for b in batches] == [2, 1]
    assert all(not b[1].any() for b in batches)
    assert batches[0][0].shape[1:] == (*HW, 3)
    assert len(val) == 1 and len(train) == 3


def test_unknown_dataset_raises_value_error(trees):
    with pytest.raises(ValueError, match="unknown datasets"):
        builder.build_loader(_cfg(trees["lidc"], "prostate"))
    with pytest.raises(ValueError, match="unknown datasets"):
        jbuilder.build_loader(_cfg(trees["lidc"], "prostate"))


# -- the transforms ----------------------------------------------------------

def _sample(seed, channels=3):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(40, 36, channels)).astype(np.float32)
    mask = (rng.random((40, 36)) > 0.6).astype(np.uint8)
    return image, mask


#: name -> call(module, image, mask, rng) -> outputs
_FUNCTIONS = {
    "resize": lambda m, i, k, r: m.resize(i, k, (32, 24)),
    "resize_no_mask": lambda m, i, k, r: m.resize(i, None, (50, 30)),
    "random_resized_crop": lambda m, i, k, r: m.random_resized_crop(
        i, k, (32, 32), rng=r),
    "random_resized_crop_fallback": lambda m, i, k, r: m.random_resized_crop(
        i, k, (32, 32), scale=(4.0, 5.0), rng=r),
    "hflip": lambda m, i, k, r: m.hflip(i, k, r),
    "vflip": lambda m, i, k, r: m.vflip(i, k, r),
    "random_rotate90": lambda m, i, k, r: m.random_rotate90(i, k, r),
    "shift_scale_rotate": lambda m, i, k, r: m.shift_scale_rotate(i, k, r),
    "shift_scale_rotate_gray": lambda m, i, k, r: m.shift_scale_rotate(
        i[..., 0], k, r, p=1.0),
    "color_jitter": lambda m, i, k, r: m.color_jitter(i, r),
    "color_jitter_gray": lambda m, i, k, r: m.color_jitter(i[..., :1], r,
                                                           p=1.0),
    "random_gamma": lambda m, i, k, r: m.random_gamma(i, r, p=0.5),
    "gauss_noise": lambda m, i, k, r: m.gauss_noise(i, r, p=0.5),
    "brightness_contrast": lambda m, i, k, r: m.brightness_contrast(i, r),
}
#: name -> build(module) -> transform(image, mask)
_TRANSFORMS = {
    "LIDCSSLTrainTransform": lambda m: m.LIDCSSLTrainTransform((32, 32), 3),
    "RRCFlipJitterTransform": lambda m: m.RRCFlipJitterTransform(
        (32, 32), seed=4),
    "RRCFlipJitterTransform_isic_ssl": lambda m: m.RRCFlipJitterTransform(
        (32, 32), (0.5, 2.0), 6),
    "BuildingTrainTransform": lambda m: m.BuildingTrainTransform((32, 32),
                                                                 seed=8),
    "ResizeTransform": lambda m: m.ResizeTransform((24, 40)),
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(_FUNCTIONS))
def test_augment_function_matches_jax(name):
    """Eight seeds each, so both sides of every probability are taken."""
    fn = _FUNCTIONS[name]
    for seed in range(8):
        image, mask = _sample(seed)
        got = _as_tuple(fn(ta, image.copy(), mask.copy(),
                           np.random.default_rng(seed)))
        want = _as_tuple(fn(ja, image.copy(), mask.copy(),
                            np.random.default_rng(seed)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.shape == w.shape, (name, seed)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {seed}")


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_train_transform_matches_jax(name):
    """Ten calls in a row on one transform: the shared generator's draws
    line up across calls too."""
    got_t, want_t = _TRANSFORMS[name](ta), _TRANSFORMS[name](ja)
    for seed in range(10):
        image, mask = _sample(20 + seed)
        (gi, gm), (wi, wm) = got_t(image, mask), want_t(image, mask)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert gi.dtype == wi.dtype == np.float32
        assert gm.dtype == wm.dtype == np.uint8


# -- preflight ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NAMES))
def test_preflight_passes_on_each_tree(trees, name):
    root = trees[NAMES[name][0]]
    num_classes = NAMES[name][1]
    assert validate_data_tree(root, name, num_classes) == []
    assert jax_validate(root, name, num_classes) == []
    preflight_or_raise(_cfg(root, name, num_classes=num_classes))


# name -> (file to remove, relative to the tree, the issue it must raise)
_BREAKS = {
    "lidc": ("mask_r/LIDC_Mask_1000.png", "train mask [0]"),
    "isic": ("gt/ISIC_0000015_segmentation.png", "test mask [3]"),
    "synapse": ("train_npz/case0000_slice000.npz", "train npz [0]"),
    "building": ("test/image/tile_0011.png", "test image [2]"),
}


@pytest.mark.parametrize("tree", sorted(_BREAKS))
def test_preflight_fails_as_jax_does(trees, tmp_path, tree):
    """A missing sample file and a missing list file each raise, with the
    same number of issues as the JAX package's validator finds."""
    import shutil

    root = str(tmp_path / tree)
    shutil.copytree(trees[tree], root)
    rel, what = _BREAKS[tree]
    os.remove(os.path.join(root, rel))
    name = "sup_building" if tree == "building" else tree
    got, want = validate_data_tree(root, name), jax_validate(root, name)
    assert len(got) == len(want) == 1 and what in got[0]
    with pytest.raises(DataPreflightError, match="1 problem"):
        preflight_or_raise(_cfg(root, name))
    list_file = "test_vol.txt" if tree == "synapse" else "test.txt"
    os.remove(os.path.join(root, list_file))
    got, want = validate_data_tree(root, name), jax_validate(root, name)
    assert len(got) == len(want) >= 1
    assert any(f"missing list file {os.path.join(root, list_file)}" in g
               for g in got)
    assert validate_data_tree(str(tmp_path / "nowhere"), name) == [
        f"data_path {str(tmp_path / 'nowhere')!r} is not a directory"]
    assert "unknown dataset" in validate_data_tree(root, "building")[0]


# -- synthetic trees ---------------------------------------------------------

@pytest.mark.parametrize("tree", sorted(TREES) + ["png_pairs"])
def test_synthetic_tree_is_byte_equal_to_jax(tmp_path, tree):
    fn, kw = TREES.get(tree, ("make_synthetic_png_pairs",
                              dict(n=4, hw=HW, seed=3)))
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert getattr(tsyn, fn)(a, **kw) == a
    getattr(jsyn, fn)(b, **kw)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    assert files(a) == files(b) and len(files(a)) >= 8
    for rel in files(a):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel
