"""The port's HDF5 reader and writer (``hpfg_tpu_torch/data/h5.py``) against
h5py, and the ACDC / Synapse loaders, the preflight and the synthetic ACDC
tree built on them against the JAX package's.

The reader must give h5py's arrays bit for bit on every storage h5py writes
by default (contiguous, compact, chunked with edge chunks, deflate at three
levels, shuffle, fletcher32) and refuse, by name, what it does not read;
h5py must read the writer's files unchanged. A CLI run in a process where
h5py cannot import trains Mean-Teacher from a gzip tree.
"""

import json
import os
import shutil
import subprocess
import sys
import zlib

import h5py
import numpy as np
import pytest

from hpfg_tpu.data.acdc import ACDCDataset as JaxACDC
from hpfg_tpu.data.preflight import validate_data_tree as jax_validate
from hpfg_tpu.data.synapse import SynapseDataset as JaxSynapse
from hpfg_tpu.data.synthetic import make_synthetic_acdc as jax_make_acdc
from hpfg_tpu.data.synthetic import make_synthetic_synapse as jax_make_synapse
from hpfg_tpu_torch.data import h5
from hpfg_tpu_torch.data.acdc import ACDCDataset
from hpfg_tpu_torch.data.preflight import validate_data_tree
from hpfg_tpu_torch.data.synapse import SynapseDataset
from hpfg_tpu_torch.data.synthetic import make_synthetic_acdc
from tests.test_torch_mean_teacher import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = ["float32", "float64", "uint8", "int16", "int32", "int64"]
SHAPES = [(7, 13), (3, 9, 11)]
#: storage -> h5py create_dataset keywords (chunks that do not divide the
#: shape, so the edge chunks overhang it); "compact" goes through the
#: low-level API
STORAGES = {
    "contiguous": {},
    "compact": None,
    "chunked": {"chunks": "edge"},
    "gzip1": {"compression": "gzip", "compression_opts": 1},
    "gzip4": {"compression": "gzip", "compression_opts": 4,
              "chunks": "edge"},
    "gzip9": {"compression": "gzip", "compression_opts": 9},
    "gzip_shuffle": {"compression": "gzip", "shuffle": True,
                     "chunks": "edge"},
    "fletcher32": {"fletcher32": True, "chunks": "edge"},
    "gzip_shuffle_fletcher32": {"compression": "gzip", "shuffle": True,
                                "fletcher32": True},
}


def _edge_chunks(shape):
    return tuple(max(1, s // 2 - 1) for s in shape)


def _write(path, name, a, storage):
    """Write ``a`` as dataset ``name`` of an open h5py file ``path``."""
    kw = STORAGES[storage]
    if kw is None:
        space = h5py.h5s.create_simple(a.shape)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(path.id, name.encode(),
                             h5py.h5t.py_create(a.dtype), space, dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a)
        return
    kw = dict(kw)
    if kw.get("chunks") == "edge":
        kw["chunks"] = _edge_chunks(a.shape)
    path.create_dataset(name, data=a, **kw)


@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}d")
@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_matches_h5py(tmp_path, dtype, shape, storage):
    rng = np.random.default_rng(zlib.crc32(repr((dtype, shape,
                                                 storage)).encode()))
    a = (rng.normal(size=shape) * 1000).astype(dtype)
    label = rng.integers(0, 4, shape).astype(np.uint8)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        _write(f, "image", a, storage)
        f.create_dataset("label", data=label, compression="gzip")
        f.create_dataset("scribble", data=(label == 1).astype(np.uint8))
    with h5py.File(path, "r") as f:
        want = {k: f[k][()] for k in f.keys()}
        if storage == "compact":
            assert f["image"].id.get_create_plist().get_layout() \
                == h5py.h5d.COMPACT
        elif STORAGES[storage]:
            assert f["image"].chunks is not None
    got = h5.File(path)
    assert got.keys() == ["image", "label", "scribble"]
    assert "image" in got and "nope" not in got
    for k, w in want.items():
        g = got[k][:]
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert np.asarray(got["image"]).tobytes() == want["image"].tobytes()


def _latest(f):
    f.create_dataset("image", data=np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("case,match", [
    ("libver_latest", "superblock version"),
    ("big_endian_int", "big-endian integer"),
    ("big_endian_float", "big-endian"),
    ("vlen_string", "variable-length"),
])
def test_reader_refuses_what_it_does_not_read(tmp_path, case, match):
    path = tmp_path / "x.h5"
    if case == "libver_latest":
        with h5py.File(path, "w", libver="latest") as f:
            _latest(f)
        with pytest.raises(NotImplementedError, match=match):
            h5.File(path)["image"][()]
        return
    with h5py.File(path, "w") as f:
        if case == "big_endian_int":
            f["image"] = np.arange(6, dtype=">i4")
        elif case == "big_endian_float":
            f["image"] = np.arange(6, dtype=">f8")
        else:
            f.create_dataset("image", data=["ab", "c"],
                             dtype=h5py.string_dtype())
    with pytest.raises(NotImplementedError, match=match):
        h5.File(path)["image"][()]


def test_reader_refuses_a_file_that_is_not_hdf5(tmp_path):
    text = tmp_path / "notes.h5"
    text.write_text("not an hdf5 file\n" * 100)
    with pytest.raises(OSError, match="not an HDF5 file"):
        h5.File(text)
    good = tmp_path / "good.h5"
    with h5py.File(good, "w") as f:
        f["image"] = np.arange(4096, dtype=np.float64)
    cut = tmp_path / "cut.h5"
    cut.write_bytes(good.read_bytes()[:3000])
    with pytest.raises(OSError):
        h5.File(cut)["image"][()]


def test_reader_reads_past_a_user_block(tmp_path):
    path = tmp_path / "u.h5"
    a = np.arange(30, dtype=np.int16).reshape(5, 6)
    with h5py.File(path, "w", userblock_size=1024) as f:
        f.create_dataset("image", data=a, compression="gzip")
    assert path.read_bytes()[:8] != h5.SIGNATURE
    np.testing.assert_array_equal(h5.File(path)["image"][()], a)


def test_fletcher32_mismatch_raises(tmp_path):
    path = tmp_path / "x.h5"
    a = np.arange(64, dtype=np.int32).reshape(8, 8)
    with h5py.File(path, "w") as f:
        f.create_dataset("image", data=a, fletcher32=True, chunks=(8, 8))
    raw = bytearray(path.read_bytes())
    at = bytes(raw).index(a.tobytes()[:64])
    raw[at + 10] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(OSError, match="fletcher32"):
        h5.File(path)["image"][()]


@pytest.mark.parametrize("shape", [(5, 7), (2, 6, 5), (), (0, 3)],
                         ids=["2d", "3d", "scalar", "empty"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_the_writer(tmp_path, dtype, shape):
    rng = np.random.default_rng(7)
    a = (rng.normal(size=shape) * 100).astype(dtype)
    lbl = rng.integers(0, 255, (4, 3)).astype(np.uint8)
    path = tmp_path / "w.h5"
    h5.write(path, {"label": lbl, "image": a})
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["image", "label"]
        assert f["image"].dtype == a.dtype and f["image"].shape == a.shape
        np.testing.assert_array_equal(f["image"][()], a)
        np.testing.assert_array_equal(f["label"][()], lbl)
    got = h5.File(path)
    np.testing.assert_array_equal(got["image"][()], a)
    assert got["image"][()].dtype == a.dtype


# -- fixtures ----------------------------------------------------------------

def fixture_arrays() -> dict:
    """{file: {dataset: array}} of the committed fixtures, from a seed."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:48, 0:40]
    disc = ((yy - 24) ** 2 + (xx - 20) ** 2 < 150).astype(np.uint8)
    vol = rng.normal(size=(5, 36, 30)).astype(np.float32)
    return {
        "gzip_slice.h5": {
            "image": (0.2 + 0.3 * disc + rng.normal(0, 0.05, disc.shape))
            .astype(np.float32),
            "label": disc},
        "gzip_shuffle_volume.h5": {
            "image": vol,
            "label": (vol > 0.5).astype(np.uint8) + (vol > 1.5)},
        "contiguous.h5": {
            "image": rng.normal(size=(16, 12)).astype(np.float64),
            "label": rng.integers(0, 4, (16, 12)).astype(np.int32)},
    }


def write_fixtures(directory) -> None:
    """Write the fixtures with h5py and ``fixtures.json`` beside them."""
    arrays = fixture_arrays()
    kw = {"gzip_slice.h5": {"compression": "gzip"},
          "gzip_shuffle_volume.h5": {"compression": "gzip", "shuffle": True,
                                     "chunks": (2, 16, 16)},
          "contiguous.h5": {}}
    listed = {}
    for fname, datasets in arrays.items():
        with h5py.File(os.path.join(directory, fname), "w") as f:
            for name, a in datasets.items():
                f.create_dataset(name, data=a, **kw[fname])
        listed[fname] = {n: {"shape": list(a.shape), "dtype": str(a.dtype),
                             "sha256": h5.array_sha256(a)}
                         for n, a in datasets.items()}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump({"written_by": f"h5py {h5py.__version__}, HDF5 "
                                 f"{h5py.version.hdf5_version}",
                   "files": listed}, f, indent=1)
        f.write("\n")


def test_fixtures_hold_the_listed_arrays():
    """The committed files read as listed through the port's reader and
    through h5py, the list matches the seeded arrays, the gzip ones are
    chunked (the volume with edge chunks) and all of them are small."""
    rows = h5.check_fixtures()
    assert len(rows) == 6 and all(r["ok"] for r in rows), rows
    with open(h5.FIXTURES / "fixtures.json") as f:
        listed = json.load(f)["files"]
    for fname, datasets in fixture_arrays().items():
        with h5py.File(h5.FIXTURES / fname, "r") as f:
            for name, a in datasets.items():
                assert listed[fname][name]["sha256"] == h5.array_sha256(a)
                np.testing.assert_array_equal(f[name][()], a)
            if fname.startswith("gzip"):
                assert f["image"].compression == "gzip"
    with h5py.File(h5.FIXTURES / "gzip_shuffle_volume.h5", "r") as f:
        assert f["image"].shuffle and f["image"].chunks == (2, 16, 16)
    assert sum(p.stat().st_size for p in h5.FIXTURES.iterdir()) < 64 * 1024


# -- loaders, preflight, synthetic trees -------------------------------------

@pytest.fixture(scope="module")
def gzip_acdc(synthetic_acdc, tmp_path_factory):
    """The ``synthetic_acdc`` tree with every h5 file rewritten as a real tree
    stores it: gzip, chunked."""
    root = str(tmp_path_factory.mktemp("acdc_gzip"))
    shutil.copytree(synthetic_acdc, root, dirs_exist_ok=True)
    for d, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".h5"):
                continue
            path = os.path.join(d, name)
            with h5py.File(path, "r") as f:
                arrays = {k: f[k][()] for k in f.keys()}
            with h5py.File(path, "w") as f:
                for k, a in arrays.items():
                    f.create_dataset(k, data=a, compression="gzip")
    return root


@pytest.mark.parametrize("tree", ["contiguous", "gzip"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_acdc_dataset_loads_the_jax_arrays(synthetic_acdc, gzip_acdc, tree,
                                           split):
    root = synthetic_acdc if tree == "contiguous" else gzip_acdc
    got, want = ACDCDataset(root, split), JaxACDC(root, split)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        for g, w in zip(got.load(i), want.load(i)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_synapse_test_volumes_load_the_jax_arrays(tmp_path):
    root = jax_make_synapse(str(tmp_path / "syn"), n_train=4, n_vols=2,
                            depth=3, hw=(24, 20))
    got, want = SynapseDataset(root, "test"), JaxSynapse(root, "test")
    assert len(got) == len(want) == 2
    for i in range(2):
        for g, w in zip(got.load(i), want.load(i)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _break(root, how):
    """Damage one file of an ACDC tree; returns its path."""
    with open(os.path.join(root, "train_slices.list")) as f:
        first = f.readline().strip()
    path = os.path.join(root, "data", "slices", f"{first}.h5")
    with h5py.File(path, "r") as f:
        image, label = f["image"][()], f["label"][()]
    if how == "missing_file":
        os.remove(path)
    elif how == "not_hdf5":
        with open(path, "w") as f:
            f.write("garbage\n")
    else:
        with h5py.File(path, "w") as f:
            f["image"] = image[None] if how == "wrong_ndim" else image
            if how == "no_label":
                f["mask"] = label
            else:
                f["label"] = (label + 10 if how == "label_range"
                              else label[:-1] if how == "shape_mismatch"
                              else label[None])
    return path


@pytest.mark.parametrize("how", ["missing_file", "not_hdf5", "no_label",
                                 "wrong_ndim", "label_range",
                                 "shape_mismatch"])
def test_validate_data_tree_gives_the_jax_issues(synthetic_acdc, tmp_path,
                                                  how):
    assert validate_data_tree(synthetic_acdc, "acdc") == []
    assert jax_validate(synthetic_acdc, "acdc") == []
    root = str(tmp_path / "acdc")
    shutil.copytree(synthetic_acdc, root)
    _break(root, how)
    got, want = validate_data_tree(root, "acdc"), jax_validate(root, "acdc")
    assert len(got) == len(want) >= 1
    if how == "not_hdf5":  # the parenthesis holds each reader's own error
        got, want = ([line.split(" (")[0] for line in lines]
                     for lines in (got, want))
    assert got == want


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_synthetic_acdc_equals_jax(tmp_path):
    kw = dict(n_train_slices=5, n_test_volumes=2, depth=3, hw=(20, 18),
              seed=4)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert make_synthetic_acdc(a, **kw) == a
    jax_make_acdc(b, **kw)
    files = _tree_files(a)
    assert files == _tree_files(b) and len(files) == 5 + 4 + 3
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if not rel.endswith(".h5"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel
            continue
        with h5py.File(pa, "r") as fa, h5py.File(pb, "r") as fb:
            assert sorted(fa.keys()) == sorted(fb.keys()) == ["image",
                                                               "label"]
            for k in fb.keys():
                assert fa[k].dtype == fb[k].dtype
                np.testing.assert_array_equal(fa[k][()], fb[k][()])


_NO_H5PY = r"""
import json, sys
sys.modules["h5py"] = None
from hpfg_tpu_torch.run import run

root, save = sys.argv[1], sys.argv[2]
t = run(["--config", "configs/mean_teacher_unet_30k_224x224_ACDC.yaml",
         "--set", f"data_path={root}", "--set", f"save_path={save}",
         "--set", "device=cpu", "--set", "precision=fp32",
         "--set", "label_num=0.25", "--set", "batch_size=2",
         "--set", "unlabel_batch_size=2", "--set", "train_crop_size=[32,32]",
         "--set", "test_crop_size=[32,32]", "--set", "total_itrs=2",
         "--set", "step_size=2", "--set", "feature_chns=[8,8,8,8,8]"])
print(json.dumps({"steps": t.algorithm.step_count,
                  "evals": [h["iter"] for h in t.history],
                  "models": sorted(t.history[-1]["results"]),
                  "h5py": sys.modules["h5py"] is not None}))
"""


def test_cli_trains_from_a_gzip_tree_without_h5py(gzip_acdc, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_H5PY, gzip_acdc, str(tmp_path / "run")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"steps": 2, "evals": [2], "models": ["model1", "model2"],
                   "h5py": False}
