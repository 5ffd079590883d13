from vdnerf_tpu_torch.io.checkpoints import (
    checkpoint_path,
    from_jax_cams,
    from_jax_params,
    latest_checkpoint,
    load_jax_checkpoint,
    load_pnf_checkpoint,
    load_reference_checkpoint,
    pnf_path,
    read_jax_cams,
    read_jax_checkpoint,
    save_pnf_checkpoint,
    save_training_checkpoint,
)
from vdnerf_tpu_torch.io.logging import MetricsWriter
from vdnerf_tpu_torch.io.recording import record_run

__all__ = [
    "checkpoint_path",
    "from_jax_cams",
    "from_jax_params",
    "latest_checkpoint",
    "load_jax_checkpoint",
    "load_pnf_checkpoint",
    "load_reference_checkpoint",
    "pnf_path",
    "read_jax_cams",
    "read_jax_checkpoint",
    "save_pnf_checkpoint",
    "save_training_checkpoint",
    "MetricsWriter",
    "record_run",
]
