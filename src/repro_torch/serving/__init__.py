from .engine import DecodeEngine, make_serve_step

__all__ = ["DecodeEngine", "make_serve_step"]
