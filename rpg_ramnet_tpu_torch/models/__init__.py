from .model import ERGB2DepthRecurrent, event_loop_range, prediction_keys

__all__ = ["ERGB2DepthRecurrent", "event_loop_range", "prediction_keys"]
