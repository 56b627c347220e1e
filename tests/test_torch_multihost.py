"""Multi-card serving of the port, two gloo ranks on the CPU, through the
server's own path (`server.main.build_engine(multihost=True)`, rank 0
leading through `server.multihost.wrap_leader` and `engine.inference`, rank
1 in `follower_loop`), in the shape of `tests/test_multihost.py:67`: the
leader's audio equals one unsharded process's for three seeds and a
streamed request, a request after an abandoned stream still matches (the
leader drained it), and the follower served every request."""

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.server.main import build_engine, parse_args
from tests.torch_dist_worker import (run_request, run_streaming_request,
                                     spawn_ranks)

torch.set_num_threads(1)

ARGS = ["--tiny", "--cpu", "--no-warmup", "--decode-chunk-size", "8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multihost")
    torch.save({"args": ARGS + ["--references-dir", str(work / "refs")]},
               work / "inputs.pt")
    got = spawn_ranks("server", 2, work)
    engine = build_engine(parse_args(ARGS + ["--references-dir",
                                             str(work / "refs")]))
    want = {seed: run_request(engine, seed) for seed in (7, 8, 11)}
    # the leader streams host partials: the unsharded run takes that path
    engine.device_partials = False
    want["stream", 9] = run_streaming_request(engine, 9)
    return got, want


@pytest.mark.parametrize("seed", [7, 8, 11])
def test_leader_audio_equals_one_unsharded_process(runs, seed):
    """Seed 11 runs after the abandoned stream of seed 10."""
    got, want = runs
    assert got[0][seed] == want[seed]


def test_streamed_audio_equals_one_unsharded_process(runs):
    got, want = runs
    assert got[0]["stream", 9] == want["stream", 9]


def test_follower_served_every_request(runs):
    got, _ = runs
    assert got[1]["served"] == 5


def test_the_lm_is_split_over_the_ranks(runs):
    got, _ = runs
    # --tiny's slow stack: 2 kv heads, one per rank
    assert got[0]["heads"] == got[1]["heads"] == 1


def test_multicard_flags_refuse_what_jax_refuses():
    from fish_speech_tpu_torch.server.main import check_args

    check_args(parse_args(["--coordinator", "h:1", "--num-hosts", "2",
                           "--host-id", "0"]), multihost=True)
    for bad in (["--pool-size", "2"], ["--int8"]):
        with pytest.raises(NotImplementedError, match="item 10"):
            check_args(parse_args(bad), multihost=True)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="shows what happens without a CUDA device")
def test_multicard_server_without_cpu_raises_without_cuda(tmp_path):
    import torch.distributed as dist

    from fish_speech_tpu_torch.server.main import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tiny", "--no-warmup", "--coordinator",
              f"file://{tmp_path}/rendezvous", "--num-hosts", "1",
              "--host-id", "0"])
    assert not dist.is_initialized()


class _Axis:
    """One rank's tp axis whose broadcasts hand out queued descriptors."""

    def __init__(self, descs=()):
        self.descs = list(descs)
        self.sent = []

    def broadcast(self, buf, src):
        self.sent.append(buf.clone())
        return torch.from_numpy(self.descs.pop(0)) if self.descs else buf


class _Session:
    """A session stand-in: `generate_stream` yields `n_ok` columns, then
    raises if `fail`."""

    def __init__(self, cfg, axis, n_ok=2, fail=False):
        import types

        self.cfg, self.n_ok, self.fail, self.started = cfg, n_ok, fail, 0
        self.mesh = types.SimpleNamespace(tp=axis, device="cpu")

    def check_request(self, prompt, max_new_tokens=0, top_k=30):
        if top_k > 64:
            raise ValueError("top_k")
        return max_new_tokens

    def generate_stream(self, prompt, seed, **kw):
        self.started += 1
        for i in range(self.n_ok):
            yield np.zeros((self.cfg.num_codebooks + 1, i + 1), np.int32)
        if self.fail:
            raise RuntimeError("a step failed")


def _tiny_cfg():
    from fish_speech_tpu_torch.config import dual_ar_tiny

    return dual_ar_tiny(num_codebooks=2, max_seq_len=16)


def test_leader_refuses_an_invalid_request_before_its_broadcast():
    from fish_speech_tpu_torch.server import multihost as mh

    cfg, axis = _tiny_cfg(), _Axis()
    s = _Session(cfg, axis)
    mh.wrap_leader(s, cfg)
    prompt = np.zeros((cfg.num_codebooks + 1, 3), np.int32)
    with pytest.raises(ValueError, match="top_k"):
        list(s.generate_stream(prompt, 5, top_k=1000))
    assert axis.sent == [] and s.started == 0
    assert len(list(s.generate_stream(prompt, 5))) == 2
    assert len(axis.sent) == 1


def test_leader_refuses_every_request_after_a_failed_stream():
    from fish_speech_tpu_torch.server import multihost as mh

    cfg, axis = _tiny_cfg(), _Axis()
    s = _Session(cfg, axis, fail=True)
    mh.wrap_leader(s, cfg)
    prompt = np.zeros((cfg.num_codebooks + 1, 3), np.int32)
    with pytest.raises(RuntimeError, match="a step failed"):
        list(s.generate_stream(prompt, 5))
    s.fail = False
    with pytest.raises(RuntimeError, match="out of lockstep"):
        list(s.generate_stream(prompt, 5))
    mh.broadcast_stop(s, cfg)  # would pair with a follower's collective
    assert len(axis.sent) == 1
    # a failure while an abandoned stream is drained counts alike
    s = _Session(cfg, axis, fail=True)
    mh.wrap_leader(s, cfg)
    g = s.generate_stream(prompt, 5)
    next(g)
    with pytest.raises(RuntimeError, match="a step failed"):
        g.close()
    with pytest.raises(RuntimeError, match="out of lockstep"):
        list(s.generate_stream(prompt, 5))


def test_follower_lets_a_failed_replay_end_it():
    from fish_speech_tpu_torch.server import multihost as mh

    cfg = _tiny_cfg()
    prompt = np.zeros((cfg.num_codebooks + 1, 3), np.int32)
    desc = mh._describe(cfg, prompt, 5, 4, 0.7, 0.8, 30, 0, False)
    stop = mh._schema(cfg)
    s = _Session(cfg, _Axis([desc, desc, stop]))
    assert mh.follower_loop(s, cfg) == 2
    s = _Session(cfg, _Axis([desc, desc, stop]), fail=True)
    with pytest.raises(RuntimeError, match="a step failed"):
        mh.follower_loop(s, cfg)
    assert s.started == 1
