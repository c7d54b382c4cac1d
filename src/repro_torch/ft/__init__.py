from repro_torch.ft.resilience import RetryPolicy, StragglerMitigator, Heartbeat

__all__ = ["RetryPolicy", "StragglerMitigator", "Heartbeat"]
