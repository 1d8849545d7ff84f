"""tests/test_torch_resume_mplug.py's resume checks for the JAX package's
mPLUG training state under `--mode full --opt lamb` (every parameter trained; LAMB's layout of
the `--opt` table): bit-equal at load, and two steps on
within that file's tolerances of the JAX CLI's own continuation.
"""
import pytest

from tests.test_torch_resume_mplug import (  # noqa: F401 (collected here)
    jax_runs, test_resume_is_bit_equal_at_load,
    test_two_steps_match_the_jax_continuation)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["full"])
def run(request, tmp_path_factory):
    return jax_runs(request.param, tmp_path_factory)
