from repro_torch.data.pipeline import DataConfig, calibration_stream, lm_batch

__all__ = ["DataConfig", "lm_batch", "calibration_stream"]
