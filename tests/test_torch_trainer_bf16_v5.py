"""One bf16 YOLOv5-KFIoU SGD step of the port against JAX's bf16
``Trainer.train_step`` at 64 px, batch 2 (a file of its own, so that its
JAX compile runs beside the v7 step of tests/test_torch_trainer_bf16.py,
whose docstring says why bf16 rounding decides the update at these
weights and how the update is held).  Measured: loss items 0.040 (bound
0.05), statistics 0.099 of the tensor's largest entry (bound 0.13); 6
parameters whose update bf16 rounding moves by less than 0.3, within 1.05
times that distance of JAX's bf16 update (bound 1.5); the port's bf16 step
1.005 times JAX's own bf16-to-float32 distance from its float32 step
(bound 0.5-2)."""

from tests.test_torch_trainer import check_train_step
from tests.torch_parity import jax_model, limit_threads


def test_v5_kfiou_bf16_step_matches_jax():
    limit_threads()
    jmodel, variables = jax_model("yolov5", seed=3, mode="kfiou")
    check_train_step(jmodel, variables, "yolov5", "kfiou", 64, bf16=True,
                     bounds={"items": 0.05, "stats": 0.13, "held_below": 0.3,
                             "held": 5, "envelope": 1.5, "own": (0.5, 2.0)})
