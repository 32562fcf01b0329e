from .inference import (BatchedStreamingInference, CropParameters,
                        SequenceScanInference, StreamingInference,
                        optimal_crop_size, optimal_scale,
                        run_batched_chunked_streaming, run_batched_streaming,
                        run_chunked_streaming)

__all__ = ["BatchedStreamingInference", "CropParameters",
           "SequenceScanInference", "StreamingInference", "optimal_crop_size",
           "optimal_scale", "run_batched_chunked_streaming",
           "run_batched_streaming", "run_chunked_streaming"]
