"""Host-side utilities (counterpart of ``nerf_downstream_tpu/utils/``)."""
