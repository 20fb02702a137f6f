"""MAPPO trainer."""

from marlnav_tpu_torch.algo.mappo import (MAPPO, Buffer, RolloutMetrics,
                                          TrainState, make_mappo)

__all__ = ["MAPPO", "Buffer", "RolloutMetrics", "TrainState", "make_mappo"]
