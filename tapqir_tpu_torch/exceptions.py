"""Exception hierarchy (counterpart of tapqir_tpu/exceptions.py)."""


class TapqirException(Exception):
    """Base class for tapqir-tpu-torch exceptions."""


class TapqirFileNotFoundError(TapqirException):
    """A required file is missing."""

    def __init__(self, name, path):
        self.name = name
        self.path = path
        super().__init__(
            f"Cannot find {name} file at {path}. "
            f"Did you run the required previous steps?"
        )


class CudaOutOfMemoryError(TapqirException):
    """The CUDA device ran out of memory. Advice is the same as the JAX
    package's: reduce --fbatch-size (e.g. 128 or 256) or --nbatch-size
    (e.g. 5)."""

    def __init__(self):
        super().__init__(
            "CUDA device ran out of memory. Try smaller --fbatch-size "
            "(e.g., 128 or 256) or smaller --nbatch-size (e.g., 5)."
        )
