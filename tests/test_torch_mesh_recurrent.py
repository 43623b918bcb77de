"""The port's meshed train step for the hybrid (zamba2-1.2b), ssm
(zamba2's stack with no attention site) and xlstm (xlstm-125m) families
on real gloo meshes (2, 2), (4, 1) and (1, 2) on the CPU, against the
reference's step and the port's unmeshed one: two steps,
accum_steps=2, each rank's stored bytes, a (2, 2) checkpoint restored
on the other meshes and without one. The cases, their set-up and
tolerances: `_torch_mesh_family_tests`."""

import pytest

pytest.importorskip("torch")

from _torch_mesh_family_tests import family_tests  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

globals().update(family_tests(("zamba2-1.2b", "zamba2-ssm", "xlstm-125m")))
