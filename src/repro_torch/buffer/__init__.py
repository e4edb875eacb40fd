from .writebuffer import WriteBuffer, WriteBufferStats

__all__ = ["WriteBuffer", "WriteBufferStats"]
