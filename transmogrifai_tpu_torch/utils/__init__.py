from .profiling import (AppMetrics, MetricsCollector, OpStep,  # noqa: F401
                        StepMetrics, install_collector, with_job_group)
