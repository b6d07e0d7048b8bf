from .layered import LayeredSpec, make_layered_decoder  # noqa: F401
