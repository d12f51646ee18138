"""The port's counterparts of the JAX package's ``examples/quickstart.py``
and ``examples/serve_sectored.py`` (``repro_torch.launch.quickstart``,
``repro_torch.launch.serve_sectored``), run at reduced size on the CPU.

* quickstart at 20,000 instructions a core: both systems' results equal
  the reference simulator's on the same mix, bit for bit, once the
  reference seeds its traces as the port does (``tests/_sim_oracle.py``),
  and the serving byte saving equals the reference's;
* serve_sectored at d_model 64: every request completes, the example's
  own checks hold (identical prompts, identical prompt and seed), the
  two other seeds diverge, and its sectored waves ran.
"""

from _sim_oracle import assert_same, salted
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro.core import simulator as jsim
from repro.runtime import sectored_decode as jsd
from repro_torch.launch import quickstart, serve_sectored

N_INSTRUCTIONS = 20_000


def test_quickstart_equals_the_reference():
    with salted():
        got = quickstart.main(["--n-instructions", str(N_INSTRUCTIONS)])
        for arch in ("baseline", "sectored"):
            want = jsim.run_system(got["mix"], arch,
                                   n_instructions=N_INSTRUCTIONS)
            assert_same(want, got[arch], arch)
    assert got["kv_bytes_saved"] == jsd.bytes_saved_fraction(32768)
    assert got["sectored"].sim.bytes_on_bus < got["baseline"].sim.bytes_on_bus


def test_serve_sectored_runs_on_the_cpu():
    got = serve_sectored.main(["--device", "cpu", "--d-model", "64"])
    assert all(got["done"]) and got["stats"]["completed"] == 6
    tokens = got["tokens"]
    assert all(len(t) == 12 for t in tokens)
    assert tokens[0] == tokens[1] and tokens[2] == tokens[3]
    assert tokens[4] != tokens[5]
    assert got["stats"]["sectored_waves"] > 0
