"""The port's SR training slice at x8 (L 3) against the JAX package on the CPU: the SR
forward (NLL) in the three recipes, calibration, encode and the NLL and pixel steps;
the checks and their tolerances are in tests/_torch_port_util.py, the x4 counterparts
in tests/test_torch_port_train.py."""

import pytest

from _torch_port_util import (RECIPE_IDS, RECIPES, check_calibrate, check_encode,
                              check_sr_forward, check_steps)


@pytest.mark.parametrize("cd,ed", RECIPES, ids=RECIPE_IDS)
def test_sr_forward_matches_jax_x8(cd, ed):
    check_sr_forward(8, cd, ed)


def test_calibrate_matches_jax_x8():
    check_calibrate(8)


@pytest.mark.parametrize("cd,ed", RECIPES, ids=RECIPE_IDS)
def test_encode_matches_jax_and_round_trips_x8(cd, ed):
    check_encode(8, cd, ed)


@pytest.mark.parametrize("cd,ed", [(None, None), (None, "bfloat16")], ids=["f32", "bf16_encoders"])
def test_nll_and_pixel_steps_match_jax_x8(cd, ed):
    check_steps(8, cd, ed)
