"""The `FSLMethod` API (``repro.core.methods``).  Importing this package
registers the methods ported so far: ``cse_fsl``."""
from repro_torch.core.methods.base import (AsyncHooks, CommProfile,
                                           FSLMethod, assemble_round_step,
                                           available_methods, get_method,
                                           register)
from repro_torch.core.methods import cse_fsl  # noqa: F401

__all__ = ["AsyncHooks", "CommProfile", "FSLMethod", "assemble_round_step",
           "available_methods", "get_method", "register", "cse_fsl"]
