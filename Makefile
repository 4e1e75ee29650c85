# Convenience targets (parity with the reference's Makefile + sanity target)

PY ?= python

.PHONY: all test sanity bench native clean

all: native

native:
	$(PY) -c "from slimfastq_tpu import native; assert native.available(), 'native build failed'; print('native host library built')"

test:
	$(PY) -m pytest tests/ -q

# quick end-to-end round-trip sanity, like the reference's `make sanity`
sanity:
	$(PY) -c "import sys; \
from slimfastq_tpu.api import encode_fastq, decode_fastq; \
from slimfastq_tpu.utils.synth import synth_fastq; \
d = synth_fastq(2000, read_len=80, seed=1, var_len=True, n_rate=0.003); \
e = encode_fastq(d, level=3, lanes=64, aux_lanes=16, block_records=512); \
assert decode_fastq(e) == d, 'round trip failed'; \
print(f'sanity OK: {len(d)} -> {len(e)} bytes (x{len(d)/len(e):.2f})')"

bench:
	$(PY) bench.py

clean:
	rm -rf slimfastq_tpu/native/build
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
