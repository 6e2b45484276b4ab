from cmgan_torch.utils.profiling import MetricsLogger, recorded, span, trace

__all__ = ["MetricsLogger", "recorded", "span", "trace"]
