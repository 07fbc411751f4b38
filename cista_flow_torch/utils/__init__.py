from .image import normalize_image

__all__ = ["normalize_image"]
