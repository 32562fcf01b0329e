from .inference import (CropParameters, SequenceScanInference,
                        StreamingInference, optimal_crop_size, optimal_scale,
                        run_chunked_streaming)

__all__ = ["CropParameters", "SequenceScanInference", "StreamingInference",
           "optimal_crop_size", "optimal_scale", "run_chunked_streaming"]
