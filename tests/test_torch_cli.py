"""The port's command line (``python -m paddle_tpu_torch``) on the CPU:
``serve --device cpu`` started as a subprocess with a ``--config`` that
loads a JAX TransformerLM's weights (saved as numpy) into the port's
model prints ``SERVING <host> <port>``, and the port's ``ServingClient``
gets tokens equal to JAX's ``generate_cached`` on those weights; a
``route`` fleet of one prefill and one decode worker (``ROUTER``,
``JOINED ... epoch``) gives the same tokens through ``RouterClient``;
SIGTERM drains and ends each process with 0. Every wait has a deadline.
"""

import os
import pickle
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu_torch.serving import RouterClient, ServingClient

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
SERVE = ["--vocab", str(VOCAB), "--d_model", str(D), "--n_heads", str(H),
         "--n_layers", str(L), "--max_len", str(MAX_LEN), "--slots", "2",
         "--segment", "4", "--page_block", "8", "--cache_bucket", "32",
         "--device", "cpu", "--drain", "1"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = dict(call_timeout=30.0)


@pytest.fixture(scope="module")
def weights(paged_model_and_params, tmp_path_factory):
    """(JAX model, params, a --config script serving them in the port)."""
    jmodel, jparams = paged_model_and_params
    d = tmp_path_factory.mktemp("cli")
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jparams), f)
    cfg = d / "config.py"
    cfg.write_text(
        "import pickle\n"
        "from paddle_tpu_torch.models import TransformerLM\n"
        f"model = TransformerLM({VOCAB}, d_model={D}, n_heads={H}, "
        f"n_layers={L}, max_len={MAX_LEN})\n"
        f"params = pickle.load(open({str(d / 'params.pkl')!r}, 'rb'))\n")
    return jmodel, jparams, str(cfg)


def _start(*argv, expect=("SERVING",), timeout=120.0):
    """The process and the words of each expected first line."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch",
                             *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT)
    deadline = time.monotonic() + timeout
    lines = []
    for word in expect:
        while True:
            assert time.monotonic() < deadline, f"no {word} line: {lines}"
            line = proc.stdout.readline()
            assert line, f"process ended before {word}: {lines}"
            lines.append(line)
            if line.startswith(word):
                break
    return proc, [ln.split() for ln in lines if ln.split()
                  and ln.split()[0] in expect]


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def _want(jmodel, jparams, prompt, n):
    out = jmodel.generate_cached(jparams, jnp.asarray(prompt)[None], n)
    return np.asarray(out)[0, len(prompt):]


def test_serve_tokens_equal_jax_generate_cached(weights):
    jmodel, jparams, cfg = weights
    proc, words = _start("serve", *SERVE, "--config", cfg,
                         "--no_prefix_cache")
    try:
        (_, host, port), = words
        client = ServingClient(host, int(port), **WAIT)
        rs = np.random.RandomState(0)
        for n_prompt in (5, 11):
            prompt = rs.randint(0, VOCAB, n_prompt).astype(np.int32)
            got = client.generate(prompt, 9, timeout_s=60.0)
            np.testing.assert_array_equal(got, _want(jmodel, jparams,
                                                     prompt, 9))
        stats = client.serving_stats()
        assert stats["pages_used"] == 0
        client.close()
    finally:
        _stop(proc)


def test_route_fleet_tokens_equal_jax_generate_cached(weights):
    """A router, a prefill worker and a decode worker started from the
    command line: a routed request (prefill, page shipping, decode) gives
    JAX's tokens."""
    jmodel, jparams, cfg = weights
    router, words = _start("route", expect=("ROUTER",))
    procs = [router]
    try:
        (_, rhost, rport), = words
        addr = f"{rhost}:{rport}"
        for role in ("prefill", "decode"):
            proc, words = _start("serve", *SERVE, "--config", cfg,
                                 "--router", addr, "--role", role,
                                 "--worker", role,
                                 expect=("SERVING", "JOINED"))
            procs.append(proc)
            assert words[1][:2] == ["JOINED", addr] and words[1][2] == "epoch"
        client = RouterClient(rhost, int(rport), **WAIT)
        deadline = time.monotonic() + 60
        while True:
            st = client.serving_stats()
            if st.get("n_decode_workers") == 1 \
                    and st.get("n_prefill_workers") == 1:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.1)
        prompt = np.random.RandomState(1).randint(0, VOCAB, 7).astype(
            np.int32)
        got = np.asarray(list(client.stream(prompt, 8, timeout_s=60.0)),
                         np.int32)
        np.testing.assert_array_equal(got, _want(jmodel, jparams, prompt, 8))
        client.close()
    finally:
        for proc in reversed(procs):
            _stop(proc)


def test_version_and_refusals(capsys):
    """``version`` answers; a prefill worker with no router is refused with
    exit 2 before any model is built; and ``train --compile_cache`` (JAX's
    XLA compilation cache) is refused with exit 2 before the config
    runs."""
    from paddle_tpu_torch import cli
    assert cli.main(["version"]) == 0
    assert "paddle_tpu_torch" in capsys.readouterr().out
    assert cli.main(["serve", *SERVE, "--role", "prefill"]) == 2
    assert "requires --router" in capsys.readouterr().err
    assert cli.main(["train", "--config", "x.py", "--compile_cache",
                     "cc", "--device", "cpu"]) == 2
    assert "compiles no XLA programs" in capsys.readouterr().err
