"""Tests that run on an NVIDIA GPU: `pytest -m gpu --gpu` on the card.
Each calls the check that chip_smoke.py runs, at production geometry
(W=1024 lanes, 64k-record blocks of 100 bp reads)."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_device_is_gpu_with_native_host(gpu):
    assert chip_smoke.check_device()["platform"] == "gpu"


def test_cli_matches_oracle(gpu, tmp_path):
    chip_smoke.check_cli(chip_smoke.smoke_data(1), chip_smoke.BLOCK,
                         str(tmp_path))


@pytest.mark.parametrize("level", [1, 2, 4])
def test_level_matches_oracle(gpu, level):
    chip_smoke.check_level(chip_smoke.smoke_data(1, seed=chip_smoke.SEED + 1),
                           level, need_match=level == 4,
                           block_records=chip_smoke.BLOCK)


def test_golden_containers(gpu):
    chip_smoke.check_golden()
