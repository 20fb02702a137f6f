"""Seeding, transforms, stats and weight files, checkpoints, profiling."""

from marlnav_tpu_torch.utils.profiling import (Throughput, annotate,
                                               checked_step, trace)

__all__ = ["Throughput", "annotate", "checked_step", "trace"]
