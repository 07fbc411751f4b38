from .image import (CropParameters, InputPadder, forward_interpolate, normalize_image,
                    optimal_crop_size, setup_seed)

__all__ = ["CropParameters", "InputPadder", "forward_interpolate", "normalize_image",
           "optimal_crop_size", "setup_seed"]
