from .engine import DecodeEngine, DecodeRequest, make_serve_step, params_from_input

__all__ = ["DecodeEngine", "DecodeRequest", "make_serve_step", "params_from_input"]
