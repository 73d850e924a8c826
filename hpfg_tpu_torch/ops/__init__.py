"""Kernels and their plain versions, losses, ramp-ups, EMA and CutMix.

The package exports what ``hpfg_tpu.ops`` does. ``ema_update`` /
``ema_update_subtree`` take modules and ``box_masks`` a
``torch.Generator`` where the JAX functions take pytrees and a key."""

from hpfg_tpu_torch.ops.losses import (  # noqa: F401
    bce_dice_l1_loss,
    bce_dice_loss,
    cross_entropy_loss,
    dense_contrastive_loss,
    dice_loss_binary,
    dice_loss_from_probs,
    dice_loss_multiclass,
    entropy_loss,
    entropy_loss_map,
    focal_loss,
    med_sup_loss,
    one_hot_labels,
    soft_dice_per_class,
    softmax_dice_loss,
    softmax_kl_loss,
    softmax_mse_loss,
    symmetric_mse_loss,
)
from hpfg_tpu_torch.ops.rampup import (  # noqa: F401
    get_current_consistency_weight,
    linear_rampup,
    sigmoid_rampup,
)
from hpfg_tpu_torch.ops.ema import ema_update, ema_update_subtree  # noqa: F401
from hpfg_tpu_torch.ops.cutmix import box_masks  # noqa: F401
