from repro_torch.train.steps import (
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

__all__ = ["make_loss_fn", "make_prefill_step", "make_serve_step", "make_train_step"]
