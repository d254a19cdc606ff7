from cyclistsocialforce_tpu_torch.utils.angles import (
    angle_difference,
    limit_angle,
    limit_magnitude,
    thresh,
)

__all__ = ["angle_difference", "limit_angle", "limit_magnitude", "thresh"]
