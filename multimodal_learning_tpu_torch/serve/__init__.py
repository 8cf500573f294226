"""Serving: the eval forward (``export``, which needs the model code) and
the loader of its artifact (``load``, which needs only torch and the
port's ``ops``).  The export side is imported on first use, so that
``load_exported`` does not import ``models``."""
from .load import load_exported

_EXPORT = ("ServingForward", "export_infer", "make_infer_fn", "manifest",
           "write_artifact")

__all__ = ["load_exported", *_EXPORT]


def __getattr__(name):
    if name in _EXPORT:
        from . import export
        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
