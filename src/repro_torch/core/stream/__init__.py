"""Job streams: the host side of a streamed replay (``source.py``)."""
