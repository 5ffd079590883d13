from vdnerf_tpu_torch.io.checkpoints import (
    from_jax_params,
    load_jax_checkpoint,
    load_reference_checkpoint,
    read_jax_checkpoint,
    save_reference_checkpoint,
)

__all__ = [
    "from_jax_params",
    "load_jax_checkpoint",
    "load_reference_checkpoint",
    "read_jax_checkpoint",
    "save_reference_checkpoint",
]
