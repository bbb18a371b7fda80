from .sliding_window import (
    SlidingWindowInferer,
    sliding_window_inference,
    sliding_window_inference_streamed,
)

__all__ = [
    "SlidingWindowInferer",
    "sliding_window_inference",
    "sliding_window_inference_streamed",
]
