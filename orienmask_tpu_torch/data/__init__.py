from .transform import FastCOCOTransform

__all__ = ["FastCOCOTransform"]
