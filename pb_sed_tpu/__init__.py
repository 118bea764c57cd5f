"""pb_sed_tpu: sound event detection framework on JAX.

See README.md for the architecture overview and SURVEY.md for the
capability blueprint (structural analysis of the fgnt/pb_sed reference).
"""
__version__ = '0.1.0'

from pb_sed_tpu import paths  # noqa: F401
from pb_sed_tpu.utils.config import Configurable  # noqa: F401
