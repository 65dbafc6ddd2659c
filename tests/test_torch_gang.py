"""Gang serving in the port (``ray_tpu_torch/llm/spmd.py``, ``llm/gang.py``
and the serving-mesh path of ``models/llama.py``) against the JAX package:
the counterparts of ``tests/test_llm_gang.py``.

- The model's mesh path: prefill and 4 decode steps' logits of the port on
  gloo ranks (tp2 as dp2 x tp2 and sp2 as dp2 x sp2 on 4 ranks, tp4 with
  the 2 kv heads straddling ranks, sp2 x tp2, and tp2 with MoE and with
  LoRA) against the JAX package's on its virtual mesh of the same tp/sp
  (the conftest's 8 CPU devices), within 1e-5 of the largest logit; every
  rank's logits bit-identical to rank 0's.
- ``SPMDGenerator`` on tp2: greedy tokens equal to teacher-forced
  ``forward`` and to JAX's ``SPMDGenerator`` on the same weights; seeded
  sampling reproducible.
- The scheduler on a one-rank ``GangLLMServer`` (the reference's fast-tier
  tests :89-323), a two-rank tp2 gang (continuous batching, prefix cache,
  greedy completions equal to ``JaxEngine``'s on a tp2 mesh, two rank
  deaths replayed byte-identically) and an sp2 gang against ``JaxEngine``
  on an sp2 mesh; ``TorchEngine``/``LLMServer`` on a tp2 config.

Weights are one set of well-conditioned numpy arrays (norms one, N(0, 1) /
sqrt(d) elsewhere), written once as a JAX ``save_pytree`` checkpoint that
both packages' engines restore. fp32 throughout: greedy tokens are
compared, and tp's sums in another order must not flip a near tie.

Each group of ranks is spawned once a module (fixtures with deadlines);
this module imports neither JAX nor ray_tpu at its top: the ranks import
it by name.
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

B, S = 2, 32
TOKENS = np.random.default_rng(1).integers(0, 256, (B, 8)).astype(np.int32)
LENGTHS = np.asarray([8, 5], np.int32)
DECODE_TOKENS = np.random.default_rng(2).integers(0, 256, (4, B)).astype(np.int32)
ADAPTERS = np.asarray([1, 2], np.int32)
LIMIT = 1e-5  # fp32: tp's sums in another order

# name -> (LlamaConfig.tiny kwargs, the port's mesh on 4 ranks, JAX's mesh)
MESH_CASES = {
    "tp2": ({}, dict(dp=2, tp=2), dict(tp=2)),
    "tp4": ({}, dict(tp=4), dict(tp=4)),
    "sp2": ({}, dict(dp=2, sp=2), dict(sp=2)),
    "sp2_tp2": ({}, dict(sp=2, tp=2), dict(sp=2, tp=2)),
    "tp2_moe": ({"moe_experts": 4}, dict(dp=2, tp=2), dict(tp=2)),
    "tp2_lora": ({}, dict(dp=2, tp=2), dict(tp=2)),
}
PROMPTS = ["hello", "worlds!"]


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _loras(seed: int) -> dict:
    """Two adapters of rank 4 on tiny (slot 0 zero, the base model)."""
    rng = np.random.default_rng(seed)
    L, e, h, kv, hd, r = 2, 64, 4, 2, 16, 4
    shapes = {"wq_a": (L, 3, e, r), "wq_b": (L, 3, r, h, hd), "wv_a": (L, 3, e, r),
              "wv_b": (L, 3, r, kv, hd)}
    out = {k: (0.3 * rng.standard_normal(s) / np.sqrt(s[-2] if k.endswith("a") else r))
           .astype(np.float32) for k, s in shapes.items()}
    for v in out.values():
        v[:, 0] = 0.0
    return out


def _case_inputs() -> dict:
    from ray_tpu_torch.models import llama as tl

    out = {}
    for i, (name, (kw, _, _)) in enumerate(MESH_CASES.items()):
        inp = {"params": _conditioned(tl._param_shapes(tl.LlamaConfig.tiny(**kw)), seed=40 + i)}
        if name.endswith("lora"):
            inp["loras"] = _loras(seed=60 + i)
        out[name] = inp
    return out


def _tiny_config(checkpoint=None, **engine_kw):
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    kw = dict(max_num_seqs=4, max_seq_len=128, prefill_buckets=(16, 32, 64, 128),
              dtype="float32")
    kw.update(engine_kw)
    return LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0,
                                       checkpoint_path=checkpoint),
                     engine=EngineConfig(**kw))


def _jax_config(port_config):
    """The same config as the JAX package's dataclasses."""
    from ray_tpu.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(model=ModelConfig(**dataclasses.asdict(port_config.model)),
                     engine=EngineConfig(**dataclasses.asdict(port_config.engine)))


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


# ---- the rank loop (module level: the ranks import it by name) ---------------


def _mesh_loop(config):
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.spmd import SPMDGenerator
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_params

    out = {}
    with torch.inference_mode():
        for name, (kw, sizes, _) in MESH_CASES.items():
            cfg = tl.LlamaConfig.tiny(**kw)
            mesh = build_mesh(MeshSpec(**sizes), "cpu")
            inp = config["cases"][name]
            params = shard_params(mesh, {k: torch.from_numpy(v) for k, v in inp["params"].items()})
            lkw = {}
            if "loras" in inp:
                lkw = {"loras": {k: torch.from_numpy(v) for k, v in inp["loras"].items()},
                       "adapter_ids": torch.from_numpy(ADAPTERS)}
            cache = tl.init_kv_cache(cfg, B, S, "cpu", mesh=mesh)
            logits, cache = tl.prefill(params, cache, torch.from_numpy(TOKENS), cfg,
                                       lengths=torch.from_numpy(LENGTHS), mesh=mesh, **lkw)
            steps = [logits]
            for toks in DECODE_TOKENS:
                logits, cache = tl.decode_step(params, cache, torch.from_numpy(toks), cfg,
                                               mesh=mesh, **lkw)
                steps.append(logits)
            out[name] = torch.stack(steps).numpy()
        gen = SPMDGenerator(config["llm_config"], mesh=build_mesh(MeshSpec(dp=2, tp=2), "cpu"),
                            device="cpu")
        ids = [gen.tokenizer.encode(p) for p in PROMPTS]
        greedy = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
        out["generator"] = gen.generate_batch(ids, sampling_params=greedy)
    train.report(out)


# ---- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny serving model's weights (vocab widened to the byte
    tokenizer's 258) as a JAX ``save_pytree`` checkpoint: (dir, params)."""
    from ray_tpu.train.checkpoint import save_pytree
    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.models import llama as tl

    cfg = _tiny_config()
    mcfg = resolve_llama_config(cfg.model, cfg.engine, min_vocab=258)
    params = _conditioned(tl._param_shapes(mcfg), seed=7)
    d = tmp_path_factory.mktemp("gang_ckpt")
    save_pytree(params, str(d))
    return str(d), params


@pytest.fixture(scope="module")
def mesh_runs(checkpoint):
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    inputs = _case_inputs()
    res = run_ranks(_mesh_loop, {"cases": inputs, "llm_config": _tiny_config(checkpoint[0])},
                    num_workers=4, use_gpu=False, timeout_s=240)
    return inputs, [r[0] for r in res]


@pytest.fixture(scope="module")
def gang1():
    from ray_tpu_torch.llm.gang import GangLLMServer

    gang = GangLLMServer(_tiny_config(decode_steps=4, decode_runahead=2), device="cpu")
    yield gang
    gang.shutdown()


@pytest.fixture(scope="module")
def gang_tp2(checkpoint):
    from ray_tpu_torch.llm.gang import GangLLMServer

    gang = GangLLMServer(_tiny_config(checkpoint[0], tensor_parallel_degree=2), device="cpu")
    yield gang
    gang.shutdown()


@pytest.fixture(scope="module")
def jax_greedy(checkpoint):
    """JaxEngine's greedy completions of PROMPTS on tp2 and sp2 meshes of the
    virtual CPU devices: {mesh: [token ids]}."""
    import jax

    from ray_tpu.llm import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    out = {}
    for name, kw in (("tp2", dict(tensor_parallel_degree=2)),
                     ("sp2", dict(sequence_parallel_degree=2))):
        spec = MeshSpec(tp=kw.get("tensor_parallel_degree", 1),
                        sp=kw.get("sequence_parallel_degree", 1))
        eng = JaxEngine(_jax_config(_tiny_config(checkpoint[0], **kw)),
                        mesh=build_mesh(spec, devices=jax.devices()[:2]))
        try:
            sp = JaxSamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
            out[name] = [eng.generate(p, sampling_params=sp).token_ids for p in PROMPTS]
        finally:
            eng.shutdown()
    return out


def _knobs(gang, decode_steps, decode_runahead=1, max_concurrent_admissions=4):
    gang.set_perf_knobs(decode_steps=decode_steps, decode_runahead=decode_runahead,
                        max_concurrent_admissions=max_concurrent_admissions)


# ---- the model's serving-mesh path ---------------------------------------------


def _jax_logits(name: str, inp: dict) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    kw, _, sizes = MESH_CASES[name]
    cfg = jl.LlamaConfig.tiny(**kw)
    mesh = build_mesh(MeshSpec(**sizes), devices=jax.devices()[:int(np.prod(list(sizes.values())))])
    sh = jl.param_shardings(cfg, mesh)
    params = {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in inp["params"].items()}
    tp = mesh.shape["tp"]
    kv = NamedSharding(mesh, P(None, None, "tp", None, None)
                       if tp > 1 and cfg.n_kv_heads % tp == 0 else P())
    cache = jl.init_kv_cache(cfg, B, S)
    cache = {"k": jax.device_put(cache["k"], kv), "v": jax.device_put(cache["v"], kv),
             "length": cache["length"]}
    lkw = {}
    if "loras" in inp:
        lkw = {"loras": {k: jnp.asarray(v) for k, v in inp["loras"].items()},
               "adapter_ids": jnp.asarray(ADAPTERS)}
    prefill = jax.jit(lambda p, c: jl.prefill(p, c, jnp.asarray(TOKENS), cfg,
                                              lengths=jnp.asarray(LENGTHS), **lkw))
    logits, cache = prefill(params, cache)
    step = jax.jit(lambda p, c, t: jl.decode_step(p, c, t, cfg, **lkw))
    steps = [logits]
    for toks in DECODE_TOKENS:
        logits, cache = step(params, cache, jnp.asarray(toks))
        steps.append(logits)
    return np.stack([np.asarray(s) for s in steps])


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_prefill_decode_logits_match_jax(mesh_runs, name):
    """The port's prefill + 4 decode steps on the mesh, every rank, against
    JAX's program on its virtual mesh of the same tp/sp."""
    inputs, ranks = mesh_runs
    got = ranks[0][name]
    assert got.shape == (5, B, 256)
    for r, res in enumerate(ranks[1:], 1):
        assert np.array_equal(res[name], got), f"rank {r}'s logits differ from rank 0's"
    want = _jax_logits(name, inputs[name])
    assert _rel(got, want) <= LIMIT, _rel(got, want)


def test_spmd_generator_matches_forward(mesh_runs, checkpoint):
    """Greedy lockstep generation on tp2 (dp2 x tp2 ranks) equals
    teacher-forced full ``forward`` of the unsharded model (the reference
    test :38)."""
    import torch

    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import llama as tl

    _, ranks = mesh_runs
    cfg = _tiny_config(checkpoint[0])
    mcfg = resolve_llama_config(cfg.model, cfg.engine, min_vocab=258)
    params = {k: torch.from_numpy(v) for k, v in checkpoint[1].items()}
    tok = ByteTokenizer()
    for r in ranks:
        assert r["generator"] == ranks[0]["generator"]
    for prompt, got in zip(PROMPTS, ranks[0]["generator"]):
        seq = tok.encode(prompt)
        n = len(seq)
        with torch.no_grad():
            for _ in range(6):
                logits = tl.forward(params, torch.tensor([seq]), mcfg)
                seq.append(int(logits[0, -1].argmax()))
        assert got == seq[n:], (got, seq[n:])


def test_spmd_generator_matches_jax_spmd_generator(mesh_runs, checkpoint):
    import jax

    from ray_tpu.llm import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.spmd import SPMDGenerator as JaxSPMDGenerator
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    _, ranks = mesh_runs
    gen = JaxSPMDGenerator(_jax_config(_tiny_config(checkpoint[0], tensor_parallel_degree=2)),
                           mesh=build_mesh(MeshSpec(tp=2), devices=jax.devices()[:2]))
    ids = [gen.tokenizer.encode(p) for p in PROMPTS]
    want = gen.generate_batch(ids, JaxSamplingParams(max_tokens=6, temperature=0.0,
                                                     ignore_eos=True))
    assert ranks[0]["generator"] == want


def test_spmd_generator_seeded_sampling_reproducible():
    """One process, no process group: no mesh (the reference test :64)."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.spmd import SPMDGenerator

    gen = SPMDGenerator(_tiny_config(), device="cpu")
    assert gen.mesh is None
    ids = [gen.tokenizer.encode("abc")]
    p = SamplingParams(max_tokens=8, temperature=0.9, seed=7, ignore_eos=True)
    a = gen.generate_batch(ids, sampling_params=p)
    assert a == gen.generate_batch(ids, sampling_params=p) and len(a[0]) == 8
    assert a != gen.generate_batch(ids, sampling_params=dataclasses.replace(p, seed=8))
    with pytest.raises(ValueError, match="exceeds the maximum"):
        gen.generate_batch([[1] * 200], sampling_params=p)


def test_order_witness_splits_only_the_listed_weights(capsys):
    """``tools/order_witness.py`` replays a tp all-reduce's summation order
    on one process: a listed weight's product is the sum, in rank order, of
    the row blocks' partial products (bit for bit), any other matmul is
    untouched, and its tiny rehearsal reports each run."""
    import json

    import torch

    from ray_tpu_torch.tools.order_witness import _SplitSum, main

    g = torch.Generator().manual_seed(0)
    x, w, v = (torch.randn(s, generator=g) for s in ((3, 5, 8), (8, 6), (8, 6)))
    with _SplitSum([w], 4):
        y, z = x @ w, torch.matmul(x, v)
    parts = [x[..., 2 * p:2 * p + 2] @ w[2 * p:2 * p + 2] for p in range(4)]
    assert torch.equal(y, ((parts[0] + parts[1]) + parts[2]) + parts[3])
    assert torch.equal(z, x @ v)
    main(["--model", "tiny", "--cpu", "--parts", "2"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["weights"], r["run"]) for r in rows] == [
        ("seeded", "repeat"), ("seeded", "split2"),
        ("conditioned", "repeat"), ("conditioned", "split2")]
    assert all(r["completions_equal"] == 16 and r["logits_rel"] < 1e-3 for r in rows)
    assert all(r["logits_rel"] > 0.0 for r in rows if r["run"] == "split2")


def test_compile_budget_matches_reference():
    """``LLMConfig.compile_budget_s`` (the gang's start-up deadline) is the
    reference's value (``ray_tpu/llm/config.py:150-160``)."""
    for kw in (dict(tensor_parallel_degree=2), {}, dict(sequence_parallel_degree=2,
                                                        seq_len_buckets=(64, 128))):
        port = _tiny_config(**kw)
        assert port.compile_budget_s() == _jax_config(port).compile_budget_s()
    assert _tiny_config(tensor_parallel_degree=2).compile_budget_s() == 120.0 + 30.0 * 5 * 2
    port = dataclasses.replace(_tiny_config(), startup_grace_s=7.0)
    assert port.compile_budget_s() == 7.0


# ---- the scheduler on a one-rank gang (the reference's fast tier) ------------------


def test_gang_multistep_decode_byte_identical(gang1):
    """decode_steps/decode_runahead do not change a fixed-seed stream: keys
    are (seed, token_index)-derived, so K=4 with a 2-deep run-ahead window
    equals K=1 sync, greedy AND sampled (the reference test :89)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang1, 4, 2)
    greedy = SamplingParams(max_tokens=12, ignore_eos=True, seed=3)
    sampled = SamplingParams(max_tokens=10, ignore_eos=True, temperature=0.8, seed=11)
    a = gang1.submit("hello world", greedy)
    b = gang1.submit("sampled path", sampled)
    assert a.done.wait(timeout=120) and b.done.wait(timeout=120)
    assert len(a.out_tokens) == 12
    assert gang1.stats()["max_inflight_seen"] >= 2, "run-ahead never engaged"
    _knobs(gang1, 1, 1)
    a1 = gang1.submit("hello world", greedy)
    b1 = gang1.submit("sampled path", sampled)
    assert a1.done.wait(timeout=120) and b1.done.wait(timeout=120)
    assert a.out_tokens == a1.out_tokens
    assert b.out_tokens == b1.out_tokens


def test_gang_stop_token_mid_scan_discards_tail(gang1):
    """A stop token landing mid-scan (step k < K) truncates the stream there
    (the reference test :119)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang1, 4, 2)
    ref = gang1.submit("stop test", SamplingParams(max_tokens=12, ignore_eos=True, seed=1))
    assert ref.done.wait(timeout=120)
    stop_tok = ref.out_tokens[2]
    cut = ref.out_tokens.index(stop_tok)
    r = gang1.submit("stop test", SamplingParams(max_tokens=12, ignore_eos=True, seed=1,
                                                 stop_token_ids=[stop_tok]))
    assert r.done.wait(timeout=120)
    assert r.finish_reason == "stop"
    assert r.out_tokens == ref.out_tokens[:cut], (r.out_tokens, ref.out_tokens)


def test_gang_concurrent_admissions_interleave(gang1):
    """Several chunked prefills are in flight at once and the
    max_concurrent_admissions cap holds (the reference test :151)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang1, 2, 1, max_concurrent_admissions=2)
    long_p = "a chunky prompt needing several prefill chunks to admit! "
    reqs = [gang1.submit(long_p + str(i), SamplingParams(max_tokens=4, ignore_eos=True))
            for i in range(3)]
    for r in reqs:
        assert r.done.wait(timeout=120)
    assert gang1.stats()["max_admissions_seen"] == 2, gang1.stats()
    assert all(len(r.out_tokens) == 4 for r in reqs)


def test_gang_same_plan_prefix_store_and_hit(gang1):
    """A hit admission may ride the SAME plan that snapshots the first
    prompt's prefix KV: the rank applies stores before admits (the
    reference test :182)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang1, 2)
    p = "another shared preamble for racing store and seed paths!!"
    c1 = gang1.submit(p, SamplingParams(max_tokens=3, ignore_eos=True))
    c2 = gang1.submit(p, SamplingParams(max_tokens=3, ignore_eos=True))
    assert c1.done.wait(timeout=120) and c2.done.wait(timeout=120)
    assert c1.out_tokens == c2.out_tokens  # concurrent double miss
    hits = gang1.stats()["prefix_hits"]
    h = gang1.submit(p, SamplingParams(max_tokens=3, ignore_eos=True))
    assert h.done.wait(timeout=120)
    assert h.prefix_hit_tokens > 0
    assert h.out_tokens == c1.out_tokens
    assert gang1.stats()["prefix_hits"] == hits + 1


def test_gang_two_stores_in_one_plan_both_hittable(gang1):
    """Two different equal-length prompts finalize in one plan: both prefix
    stores must land (the reference test :207)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang1, 2, 1, max_concurrent_admissions=2)
    pa = "prompt alpha shares admission plan with its twin brother!"
    pb = "prompt bravo shares admission plan with its twin sibling!"
    sp = SamplingParams(max_tokens=3, ignore_eos=True)
    a, b = gang1.submit(pa, sp), gang1.submit(pb, sp)
    assert a.done.wait(timeout=120) and b.done.wait(timeout=120)
    ha, hb = gang1.submit(pa, sp), gang1.submit(pb, sp)
    assert ha.done.wait(timeout=120) and hb.done.wait(timeout=120)
    assert ha.prefix_hit_tokens > 0 and hb.prefix_hit_tokens > 0
    assert ha.out_tokens == a.out_tokens
    assert hb.out_tokens == b.out_tokens


def test_gang_stream_paces_multistep_bursts(gang1):
    """completions_stream with K=4 yields one chunk per token with nonzero
    gaps for paced bursts (the reference test :260)."""
    import time

    _knobs(gang1, 4, 2)
    arrivals, chunks = [], []
    for c in gang1.completions_stream({"prompt": "pace me", "max_tokens": 12, "seed": 2,
                                       "ignore_eos": True}):
        assert "error" not in c, c
        arrivals.append(time.monotonic())
        chunks.append(c)
    assert len(chunks) >= 8, len(chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    gaps = np.diff(np.asarray(arrivals[:-1]))
    assert gaps.size and float(np.percentile(gaps, 50)) > 0.0
    chat = gang1.chat({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                       "ignore_eos": True})
    assert chat["object"] == "chat.completion" and chat["usage"]["completion_tokens"] == 3


def test_gang_fronts_share_one_openai_surface(gang1):
    """GangLLMServer's OpenAI methods are LLMServer's over the gang's
    engine: a greedy request streams the same chunks, one a token, through
    either front, and the unary reply carries the same tokens' text."""
    from ray_tpu_torch.llm.server import LLMServer, _sampling

    _knobs(gang1, 4, 2)
    body = {"prompt": "the same text through either front", "max_tokens": 10,
            "ignore_eos": True}
    front = LLMServer(gang1.llm_config, engine=gang1.engine)
    via_gang = [c["choices"][0]["text"] for c in gang1.completions_stream(body)]
    via_server = [c["choices"][0]["text"] for c in front.completions_stream(body)]
    assert via_gang == via_server and len(via_gang) == 11 and via_gang[-1] == ""
    out = gang1.engine.generate(body["prompt"], sampling_params=_sampling(body))
    assert gang1.completions(body)["choices"][0]["text"] == out.text
    assert via_gang[:-1] == [gang1.tokenizer.decode([t]) for t in out.token_ids]
    assert gang1.completions({**body, "_lora": "a"})["error"]["code"] == 404
    assert gang1.model_info()["gang"]["world"] == 1


def test_gang_shutdown_unblocks_inflight_streams():
    """shutdown() while a request is mid-stream fails the request (and puts
    its stream sentinel) instead of stranding its consumer (the reference
    test :323); no rank outlives it."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.gang import GangLLMServer

    gang = GangLLMServer(_tiny_config(decode_steps=4, decode_runahead=2), device="cpu")
    procs = gang.workers
    try:
        req = gang.submit("stream me into a shutdown",
                          SamplingParams(max_tokens=400, ignore_eos=True))
        assert isinstance(req.stream_queue.get(timeout=120), int)
    finally:
        gang.shutdown()
    assert req.done.wait(timeout=60), "shutdown stranded an in-flight request"
    assert req.finish_reason == "error" and req.error is not None
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="shut down"):
        gang.submit("late", SamplingParams(max_tokens=2))
    assert gang.completions({"prompt": "late", "max_tokens": 2})["error"]["code"] == 400


# ---- a two-rank tp2 gang, an sp2 gang, and the TorchEngine front -------------------


def test_gang_tp2_continuous_batching_and_prefix_cache(gang_tp2):
    """A request is admitted MID-DECODE of another, per-token streaming
    works, and a repeated prompt hits the prefix cache (the reference test
    :378)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang_tp2, 1)
    assert gang_tp2.gang_info["mesh"]["tp"] == 2 and gang_tp2.gang_info["world"] == 2
    req_a = gang_tp2.submit("a long prompt that needs several prefill chunks to admit!",
                            SamplingParams(max_tokens=60, ignore_eos=True))
    assert isinstance(req_a.stream_queue.get(timeout=120), int)
    req_b = gang_tp2.submit("hi", SamplingParams(max_tokens=2, ignore_eos=True))
    assert req_b.done.wait(timeout=120)
    assert not req_a.done.is_set(), "B finished only after A: no mid-decode admission"
    assert req_a.done.wait(timeout=120)
    assert len(req_a.out_tokens) == 60 and req_a.finish_reason == "length"
    p = "the quick brown fox jumps over the lazy dog, twice over"
    g1 = gang_tp2.submit(p, SamplingParams(max_tokens=3, ignore_eos=True))
    assert g1.done.wait(timeout=120)
    g2 = gang_tp2.submit(p, SamplingParams(max_tokens=3, ignore_eos=True))
    assert g2.done.wait(timeout=120)
    assert g2.prefix_hit_tokens > 0, "the second identical prompt missed the prefix cache"
    assert g1.out_tokens == g2.out_tokens


def test_gang_tp2_greedy_equals_jax_engine(gang_tp2, jax_greedy):
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang_tp2, 4, 2)
    sp = SamplingParams(max_tokens=8, ignore_eos=True)
    reqs = [gang_tp2.submit(p, sp) for p in PROMPTS]
    for r in reqs:
        assert r.done.wait(timeout=120)
    assert [r.out_tokens for r in reqs] == jax_greedy["tp2"]


def _death_replay(gang, rank: int, params, prompt: str):
    """Kill ``rank``'s process once ``prompt``'s first token streamed; the
    request, and the same request again, must finish byte-identical, with
    one rebuild between them (a fresh gang: no rank process kept)."""
    before = gang.stats()["rebuilds"]
    pids = {p.pid for p in gang.workers}
    req = gang.submit(prompt, params)
    assert isinstance(req.stream_queue.get(timeout=120), int)
    gang.workers[rank].kill()
    gang.workers[rank].join(timeout=30)
    assert req.done.wait(timeout=180), "the request never completed after the rebuild"
    assert req.finish_reason == "length", req.error
    assert len(req.out_tokens) == params.max_tokens, "replay duplicated or dropped tokens"
    ref = gang.submit(prompt, params)
    assert ref.done.wait(timeout=180), "the request was lost across the rebuild"
    assert ref.finish_reason == "length", ref.error
    assert ref.out_tokens == req.out_tokens
    assert gang.stats()["rebuilds"] == before + 1
    assert not pids & {p.pid for p in gang.workers}, "the rebuild kept a rank"


def test_gang_worker_death_rebuilds_and_replays(gang_tp2):
    """A rank killed mid-request, plans in the run-ahead window: the whole
    gang is rebuilt (fresh processes and store) and the request replayed
    byte-identically (the reference tests :290 and :422)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang_tp2, 4, 2)
    _death_replay(gang_tp2, 1, SamplingParams(max_tokens=40, ignore_eos=True, temperature=0.7,
                                              seed=5), "tell me a story")


def test_gang_worker_death_with_fully_dispatched_budget(gang_tp2):
    """max_tokens <= decode_steps: a request's whole budget rides the plan
    of its final prefill chunk, and its slot is freed at dispatch. The
    first run lands before the kill; the second meets the dead rank when
    that plan is sent, so the one record is the only reference to it, and
    the rebuild must still find and replay it (the reference test :345)."""
    from ray_tpu_torch.llm import SamplingParams

    _knobs(gang_tp2, 8, 2)
    _death_replay(gang_tp2, 0, SamplingParams(max_tokens=4, ignore_eos=True, seed=13),
                  "short budget")


def test_gang_sp2_greedy_equals_jax_engine(checkpoint, jax_greedy):
    """sp2: each rank computes what its tp group (of one) computes, as the
    JAX program does: the tokens equal JaxEngine's on an sp2 mesh."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.gang import GangLLMServer

    gang = GangLLMServer(_tiny_config(checkpoint[0], sequence_parallel_degree=2, decode_steps=4),
                         device="cpu")
    try:
        assert gang.gang_info["mesh"]["sp"] == 2
        sp = SamplingParams(max_tokens=8, ignore_eos=True)
        reqs = [gang.submit(p, sp) for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(timeout=120)
        assert [r.out_tokens for r in reqs] == jax_greedy["sp2"]
    finally:
        gang.shutdown()


def test_torch_engine_tp2_front_serves_through_llm_server(checkpoint, jax_greedy):
    """``TorchEngine`` on a tp2 config is a gang of two ranks behind the
    engine's surface, and ``LLMServer`` serves it unchanged, adapters
    included (``tests/test_torch_gang_lora.py`` holds their tokens to
    JAX's)."""
    from ray_tpu_torch.llm import LLMServer, SamplingParams, TorchEngine
    from ray_tpu_torch.llm.gang import GangEngine

    server = LLMServer(_tiny_config(checkpoint[0], tensor_parallel_degree=2, max_loras=1,
                                    lora_rank=4), device="cpu")
    try:
        assert isinstance(server.engine, GangEngine)
        server.check_health()
        out = server.completions({"prompt": PROMPTS[0], "max_tokens": 8, "ignore_eos": True})
        assert out["usage"]["completion_tokens"] == 8
        assert out["choices"][0]["text"] == server.engine.tokenizer.decode(jax_greedy["tp2"][0])
        stream = list(server.engine.generate_stream(
            PROMPTS[1], sampling_params=SamplingParams(max_tokens=8, ignore_eos=True)))
        assert [s["token_id"] for s in stream] == jax_greedy["tp2"][1]
        assert server.stats()["gang"]["mesh"]["tp"] == 2
        assert server.load_lora("a", {k: v[:, 1] for k, v in _loras(seed=5).items()})
        assert server.list_loras() == ["a"]
        adapted = server.completions({"prompt": PROMPTS[0], "max_tokens": 8, "ignore_eos": True,
                                      "_lora": "a"})
        assert adapted["usage"]["completion_tokens"] == 8
    finally:
        server.engine.shutdown()
    assert TorchEngine.__new__(TorchEngine, _tiny_config()).__class__ is TorchEngine
