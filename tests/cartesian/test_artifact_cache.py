"""Cross-process artifact cache: warm loads must be bitwise-identical to
cold builds (regression: persisting the whole StencilAnalysis dangled its
id(stmt)-keyed extent tables after unpickling and silently served wrong
per-statement halos -- caught by the FV oracle parity test)."""

import os
import subprocess
import sys
import tempfile

_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from gt4py_tpu.models.fv_advection import FvAdvection

NI = NJ = 12; NK = 3; H = FvAdvection.HALO
m = FvAdvection(NI, NJ, NK, dtype=np.float64, backend="numpy")
st = m.init_state(seed=1)
L = {{k: np.transpose(v, (1, 2, 0)).copy() for k, v in st.items()}}
q = m.run_numpy_oracle(L["q"], L["cx"], L["cy"])
print("CHECKSUM", repr(float(np.sum(q[H:H+NI, H:H+NJ]))))
"""

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_warm_artifact_cache_is_bitwise_identical(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(_SCRIPT.format(repo=_REPO))
    env = dict(os.environ)
    env["GT4PY_TPU_CACHE_ROOT"] = str(tmp_path / "cache")
    env["JAX_PLATFORMS"] = "cpu"

    def run():
        out = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            env=env, timeout=180,
        )
        assert out.returncode == 0, out.stdout + out.stderr
        for line in out.stdout.splitlines():
            if line.startswith("CHECKSUM"):
                return line
        raise AssertionError(out.stdout)

    cold = run()
    assert (tmp_path / "cache" / "artifacts").is_dir()  # cache populated
    warm = run()
    assert cold == warm
