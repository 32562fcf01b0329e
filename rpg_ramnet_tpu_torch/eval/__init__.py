from .inference import SequenceScanInference, run_chunked_streaming

__all__ = ["SequenceScanInference", "run_chunked_streaming"]
