from .inference_options import (set_depth_inference_options,
                                set_inference_options)

__all__ = ["set_depth_inference_options", "set_inference_options"]
