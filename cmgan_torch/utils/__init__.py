from cmgan_torch.utils.profiling import MetricsLogger, StepTimer, annotate, trace

__all__ = ["MetricsLogger", "StepTimer", "annotate", "trace"]
