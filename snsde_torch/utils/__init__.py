from .observability import (StepTimer, device_memory_stats, log_jsonl,
                            memory_delta, profile_trace, seed_everything)

__all__ = ["StepTimer", "device_memory_stats", "log_jsonl", "memory_delta",
           "profile_trace", "seed_everything"]
