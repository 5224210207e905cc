"""Data sources of the port (numpy only)."""

from mrla_tpu_torch.data.synthetic import synthetic_detection_batches

__all__ = ["synthetic_detection_batches"]
