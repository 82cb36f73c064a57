"""One YOLOv5-CSL SGD step of the port against JAX ``Trainer.train_step``
at 128 px, batch 2, at the bounds of tests/test_torch_trainer.py (a file
of its own, so that its JAX compile runs beside the v7 step)."""

from tests.test_torch_trainer import check_train_step
from tests.torch_parity import jax_model, limit_threads


def test_v5_train_step_matches_jax():
    limit_threads()
    jmodel, variables = jax_model("yolov5", seed=3)
    check_train_step(jmodel, variables, "yolov5")
