"""Training: schedules, reference init, optimizer, the accumulating step."""

from ryolo_tpu_torch.train.trainer import (LOSS_FNS, Trainer,  # noqa: F401
                                           csl_loss_fn, fitness,
                                           kfiou_loss_fn, make_optimizer,
                                           one_cycle, weights_init_normal)
