"""slimfastq_tpu: lossless FASTQ codec for a JAX accelerator (GPU).

A from-scratch JAX re-design of the capabilities of
Infinidat/slimfastq (see SURVEY.md): adaptive context-model range coding of
FASTQ id/sequence/quality streams, levels 1-4, bit-exact round trip —
with the serial coder re-derived as a lane-interleaved lockstep kernel and
the file format as a sharded, independently-decodable block container.
"""

__version__ = "0.1.0"

from .api import (decode_fastq, decode_file, encode_fastq,  # noqa: F401
                  encode_file)
from .config import CodecConfig, config_for_level  # noqa: F401
