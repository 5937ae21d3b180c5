from . import library  # noqa: F401  (registers torch.ops.photohive.*)
