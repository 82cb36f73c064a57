"""Training losses on the fixed candidate lattice: CSL and KFIoU."""

from ryolo_tpu_torch.losses.csl import csl_loss  # noqa: F401
from ryolo_tpu_torch.losses.kfiou import kfiou_loss  # noqa: F401
