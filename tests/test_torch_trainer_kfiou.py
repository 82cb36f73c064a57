"""One YOLOv7-KFIoU SGD step of the port against JAX
``Trainer.train_step`` at 128 px, batch 2 (targets without CSL bins, as
the loader gives them in KFIoU mode), at the bounds of
tests/test_torch_trainer.py (measured: loss items 2.7e-5, BN statistics
1.9e-5, the update 0.0024 in the worst tensor and 0.0019 over all
parameters; a file of its own, so that its JAX compile runs beside the
CSL steps)."""

from tests.test_torch_trainer import check_train_step
from tests.torch_parity import jax_model, limit_threads


def test_kfiou_train_step_matches_jax():
    limit_threads()
    jmodel, variables = jax_model("yolov7", seed=3, mode="kfiou")
    check_train_step(jmodel, variables, "yolov7", "kfiou")
