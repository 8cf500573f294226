from .export import (export_infer, load_exported, make_infer_fn, manifest,
                     write_artifact)

__all__ = ["export_infer", "load_exported", "make_infer_fn", "manifest",
           "write_artifact"]
