from repro_torch.train.steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
