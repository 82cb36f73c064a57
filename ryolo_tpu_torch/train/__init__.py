"""Training: schedules, reference init, optimizer, the accumulating step."""

from ryolo_tpu_torch.train.trainer import (Trainer, csl_loss_fn,  # noqa: F401
                                           fitness, make_optimizer, one_cycle,
                                           weights_init_normal)
