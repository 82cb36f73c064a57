"""Training losses: the CSL loss on the fixed candidate lattice."""

from ryolo_tpu_torch.losses.csl import csl_loss  # noqa: F401
