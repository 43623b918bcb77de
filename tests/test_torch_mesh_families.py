"""The port's meshed train step for the vlm (internvl2-2b) and encdec
(whisper-tiny) families on real gloo meshes (2, 2), (4, 1) and (1, 2)
on the CPU, against the reference's step and the port's unmeshed one:
two steps, accum_steps=2, each rank's stored bytes, a (2, 2) checkpoint
restored on the other meshes and without one; and, here beside the
shorter of the two family files, the train CLI across a mesh for the
hybrid family (zamba2's smoke config) and `chip_smoke.py`'s phase 16b
(every family's layer split over ranks run as threads) at the smoke
configs. The cases, their set-up and tolerances:
`_torch_mesh_family_tests`."""

import pytest

pytest.importorskip("torch")

from _torch_mesh_family_tests import (  # noqa: E402,F401
    family_tests, test_cli_trains_a_hybrid_saves_and_resumes_across_a_mesh,
    test_split_layers_on_threads_equal_the_unsplit,
)
from _torch_threads import one_torch_thread  # noqa: E402,F401

globals().update(family_tests(("internvl2-2b", "whisper-tiny")))
