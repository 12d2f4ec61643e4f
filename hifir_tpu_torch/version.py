"""Version info: a copy of ``hifir_tpu/version.py``.

Mirrors the reference library's version macros (``src/hif/version.h``);
the reference is v0.2.0, this framework keeps its own version.
"""

__version__ = "0.1.0"

VERSION_MAJOR = 0
VERSION_MINOR = 1
VERSION_PATCH = 0


def version() -> str:
    """Return the framework version string (ref: ``src/hifir.hpp:52``)."""
    return __version__
