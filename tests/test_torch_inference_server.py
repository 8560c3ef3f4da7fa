"""The port's inference server, CLI and client (vision_ft_tpu_torch.tools),
on the CPU: the window micro-batcher's grouping on a stub model, with an
injected clock instead of wall-clock timing; the HTTP surface on
127.0.0.1; the request validators and family rules; ``T2IModel`` on a tiny
seeded SDXL checkpoint and YAML behind both schedulers; the CLI writing a
webp; a tiny seeded CogView4 behind the server, the CLI with its denoiser
in NF4 and the CogView4 quantization tool; the client posting to a running
server.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests import test_torch_cogview4 as cogview4_tests
from tests import test_torch_wan as wan_tests
from tests.test_torch_sdxl import _tiny_kwargs
from vision_ft_tpu_torch.models.autoencoder import AutoencoderKLConfig
from vision_ft_tpu_torch.models.cogview4.config import DenoiserConfig as CogView4DenoiserConfig
from vision_ft_tpu_torch.models.cogview4.pipeline import CogView4Model
from vision_ft_tpu_torch.models.sdxl.pipeline import SDXLModel
from vision_ft_tpu_torch.models.text_encoders import glm, sentencepiece
from vision_ft_tpu_torch.models.wan import Wan22
from vision_ft_tpu_torch.models.wan.config import DenoiserConfig as WanDenoiserConfig
from vision_ft_tpu_torch.models.wan.text_encoder import TextEncoderConfig as WanT5Config
from vision_ft_tpu_torch.models.wan.vae3d import CausalVAE, WanVAEConfig
from vision_ft_tpu_torch.ops.nf4_matmul import nf4_matmul_forward
from vision_ft_tpu_torch.tools import cogview4_quant_compare, inference_cli, inference_client
from vision_ft_tpu_torch.tools import inference_server as srv
from vision_ft_tpu_torch.tools.inference_server import (
    ContinuousScheduler,
    GenerationParams,
    MicroBatcher,
    T2IModel,
    batch_key,
    make_handler,
)
from vision_ft_tpu_torch.utils import safetensors as st
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


class StubModel:
    def __init__(self):
        self.batches: list[list[GenerationParams]] = []

    def generate_batch(self, batch):
        self.batches.append(list(batch))
        return [Image.new("RGB", (p.width, p.height)) for p in batch]


class FakeClock:
    """A clock the test moves: the batcher's window closes only when it says."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _wait_until(condition, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _submit_all(batcher, params_list):
    """Submit each request from its own thread; returns (results, threads)."""
    results = [None] * len(params_list)

    def run(i):
        try:
            results[i] = batcher.submit(params_list[i])
        except Exception as exc:  # the test inspects it
            results[i] = exc

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(params_list))]
    for th in threads:
        th.start()
    return results, threads


def _join(threads):
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()


def _close_windows(batcher, clock, queued, done):
    """Once ``queued`` requests wait, move the clock on, window after window,
    until ``done()``: the worker may read the clock for its deadline before
    or after a move, so one move alone could leave its window open."""
    _wait_until(lambda: batcher.queued() == queued, f"{queued} queued requests")
    deadline = time.monotonic() + 30.0
    while not done():
        if time.monotonic() > deadline:
            raise AssertionError("the window never closed")
        clock.now += 10.0
        batcher.wake()
        time.sleep(0.001)


@pytest.mark.parametrize("pad", [True, False])
def test_compatible_requests_coalesce_within_the_window(pad):
    """Three compatible requests queued inside the window become one batch
    (padded to the bucket of 4, its last request repeated, or not); each
    gets its own image."""
    model, clock = StubModel(), FakeClock()
    batcher = MicroBatcher(model, max_batch=4, window_ms=1000, pad_to_bucket=pad, clock=clock)
    params = [GenerationParams(prompt=f"p{i}", width=64, height=64) for i in range(3)]
    results, threads = _submit_all(batcher, params)
    _close_windows(batcher, clock, 3, lambda: model.batches)
    _join(threads)
    assert len(model.batches) == 1
    batch = model.batches[0]
    assert sorted(p.prompt for p in batch[:3]) == ["p0", "p1", "p2"]
    assert len(batch) == (4 if pad else 3) and (not pad or batch[3] is batch[2])
    assert all(r.size == (64, 64) for r in results)


def test_a_full_group_runs_without_waiting_for_the_window():
    """max_batch compatible requests close their group at once: the
    clock never moves."""
    model = StubModel()
    batcher = MicroBatcher(model, max_batch=2, window_ms=1000, clock=FakeClock())
    results, threads = _submit_all(
        batcher, [GenerationParams(prompt=f"p{i}", width=64, height=64) for i in range(4)])
    _join(threads)
    assert [len(b) for b in model.batches] == [2, 2]


def test_incompatible_requests_never_share_a_batch():
    model, clock = StubModel(), FakeClock()
    batcher = MicroBatcher(model, max_batch=8, window_ms=1000, pad_to_bucket=False, clock=clock)
    params = [GenerationParams(prompt=f"p{i}", width=64 if i % 2 else 128, height=64)
              for i in range(6)]
    results, threads = _submit_all(batcher, params)
    _close_windows(batcher, clock, 6, lambda: len(model.batches) == 2)
    _join(threads)
    assert sorted(len(b) for b in model.batches) == [3, 3]
    for batch in model.batches:
        assert len({batch_key(p) for p in batch}) == 1
    assert [r.size for r in results] == [(128, 64), (64, 64)] * 3


def test_seeded_requests_run_alone():
    model = StubModel()
    batcher = MicroBatcher(model, max_batch=4, window_ms=1000, clock=FakeClock())
    results, threads = _submit_all(
        batcher, [GenerationParams(prompt="p", width=64, height=64, seed=1)] * 3)
    _join(threads)
    assert [len(b) for b in model.batches] == [1, 1, 1]


def test_an_error_reaches_every_request_of_the_group():
    class Exploding(StubModel):
        def generate_batch(self, batch):
            raise RuntimeError("boom")

    clock = FakeClock()
    batcher = MicroBatcher(Exploding(), max_batch=4, window_ms=1000, clock=clock)
    results, threads = _submit_all(batcher, [GenerationParams(prompt="x", width=64, height=64)] * 3)
    _close_windows(batcher, clock, 3, lambda: all(r is not None for r in results))
    _join(threads)
    assert all(isinstance(r, RuntimeError) and str(r) == "boom" for r in results)


def _post(port, body, path="/predict", timeout=60):
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(request, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _serving(batcher):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_http_round_trip():
    """Concurrent posts through the window batcher come back as webp of the
    asked size; /health answers; a body that does not validate is a 422, an
    unknown path a 404."""
    model, clock = StubModel(), FakeClock()
    batcher = MicroBatcher(model, max_batch=4, window_ms=1000, clock=clock)
    server, port = _serving(batcher)
    try:
        responses = [None] * 3

        def post(i):
            responses[i] = _post(port, {"prompt": f"hi {i}", "width": 64, "height": 128})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        _close_windows(batcher, clock, 3, lambda: model.batches)
        _join(threads)
        for status, ctype, data in responses:
            assert status == 200 and ctype == "image/webp"
            assert Image.open(io.BytesIO(data)).size == (64, 128)
        assert [len(b) for b in model.batches] == [4]  # 3 requests padded to the bucket
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(port, {"prompt": "x", "width": 65})
        assert bad.value.code == 422
        with pytest.raises(urllib.error.HTTPError) as missing:
            _post(port, {"prompt": "x"}, path="/nowhere")
        assert missing.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_generation_params_validators():
    for bad in (dict(width=65), dict(height=100), dict(cfg_rescale=1.5), dict(cfg_trunc_ratio=-0.1),
                dict(renorm_cfg=-0.1), dict(distilled_guidance=-1.0), dict(frames=0), dict(fps=0)):
        with pytest.raises(ValueError):
            GenerationParams(prompt="x", **bad)
    p = GenerationParams(prompt="x")
    assert (p.width, p.height, p.inference_steps, p.cfg_scale) == (768, 1024, 25, 6.5)
    keys = {batch_key(GenerationParams(prompt="a", width=64, height=64, **kw)) for kw in
            (dict(), dict(renorm_cfg=2.0), dict(cfg_trunc_ratio=0.5), dict(cfg_rescale=0.5),
             dict(seed=1), dict(inference_steps=8))}
    assert len(keys) == 6


def _stub_t2i(family):
    model = T2IModel.__new__(T2IModel)
    model._family, model._extra, model._lock = family, {}, threading.Lock()
    calls = {}

    class _Pipeline:
        def generate(self, **kwargs):
            calls.update(kwargs)
            return [None] * len(kwargs["prompt"])

    model.model = _Pipeline()
    return model, calls


def test_family_only_generation_knobs():
    """A knob another family owns is refused before any work; Lumina2's
    reach its generate() by their names; the seed rides along."""
    sdxl, calls = _stub_t2i("sdxl")
    for bad, owner in ((dict(renorm_cfg=2.0), "Lumina2"), (dict(cfg_trunc_ratio=0.25), "Lumina2"),
                       (dict(distilled_guidance=3.5), "Flux"), (dict(frames=8), "Wan")):
        with pytest.raises(ValueError, match=f"{owner}-only"):
            sdxl.generate_batch([GenerationParams(prompt="x", width=64, height=64, **bad)])
    sdxl.generate_batch([GenerationParams(prompt="x", width=64, height=64, cfg_rescale=0.5,
                                          seed=3)])
    assert calls["cfg_rescale"] == 0.5 and calls["seed"] == 3
    lumina, calls = _stub_t2i("lumina2")
    with pytest.raises(ValueError, match="SDXL-only"):
        lumina.generate_batch([GenerationParams(prompt="x", width=64, height=64, cfg_rescale=0.5)])
    lumina.generate_batch([GenerationParams(prompt="x", width=64, height=64, renorm_cfg=1.5,
                                            cfg_trunc_ratio=0.25)])
    assert calls["renorm_cfg_scale"] == 1.5 and calls["cfg_truncation_ratio"] == 0.25


def test_t2imodel_refuses_flags_and_families_before_loading(tmp_path):
    with pytest.raises(ValueError, match="must be >= 1"):
        T2IModel("does-not-exist.yml", None, None, family="sdxl", deep_cache_interval=0)
    with pytest.raises(ValueError, match="unsupported server family"):
        T2IModel("does-not-exist.yml", None, None, family="sd3")


def test_continuous_scheduler_validation():
    unsupported = T2IModel.__new__(T2IModel)
    unsupported._family = "wan"
    with pytest.raises(ValueError, match="currently serves"):
        ContinuousScheduler(unsupported, height=64, width=64)
    sched = ContinuousScheduler.__new__(ContinuousScheduler)
    sched.height, sched.width, sched._family = 64, 64, "sdxl"
    with pytest.raises(ValueError, match="fixed at 64x64"):
        sched.submit(GenerationParams(prompt="x", width=128, height=64))
    for bad, owner in ((dict(renorm_cfg=2.0), "Lumina2"), (dict(distilled_guidance=3.0), "Flux"),
                       (dict(frames=8), "Wan")):
        with pytest.raises(ValueError, match=f"{owner}-only"):
            sched.submit(GenerationParams(prompt="x", width=64, height=64, **bad))
    sched._family = "lumina2"
    with pytest.raises(ValueError, match="SDXL-only"):
        sched.submit(GenerationParams(prompt="x", width=64, height=64, cfg_rescale=0.5))


@pytest.mark.parametrize("module", [srv, inference_cli])
def test_help_names_exactly_the_served_families(module, capsys):
    """The help text, the docstring's family list and the served set agree
    (the JAX tool's help named 3 of the 5 families it served)."""
    with pytest.raises(SystemExit):
        module.build_parser().parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    named = {f for f in srv.SERVED_FAMILIES if f in text}
    assert named == set(srv.SERVED_FAMILIES) == {
        "sdxl", "lumina2", "auraflow", "cogview4", "flux", "wan"}
    doc = " ".join(module.__doc__.split())
    assert ("sdxl, lumina2, auraflow, cogview4, flux and wan" in doc
            or "sdxl, lumina2, auraflow, cogview4, flux, wan" in doc)


# -- a real model, from a single-file checkpoint ------------------------------------------


def _clip_vocab(path):
    """A CLIP BPE vocab inside the tiny towers' 1000 ids (letters, digits,
    the comma), bos 998, eos 999."""
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789,":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab.update({"ca": len(vocab), "cat</w>": len(vocab) + 1})
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 998, 999
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\nc a\nca t</w>\n")


@pytest.fixture(scope="module")
def tiny_sdxl(tmp_path_factory):
    """A tiny SDXL's seeded weights in a single-file checkpoint, a YAML that
    names it, and a CLIP vocab dir."""
    work = tmp_path_factory.mktemp("tiny_sdxl")
    config, kwargs = _tiny_kwargs("torch")
    model = SDXLModel(config, **kwargs)
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    st.save_file({k: v.contiguous() for k, v in model.state_dict().items()},
                 work / "sdxl.safetensors")
    _clip_vocab(work)
    model_config = config.model_dump(mode="json")
    model_config.update(checkpoint_path=str(work / "sdxl.safetensors"))
    (work / "serve.yml").write_text(yaml.safe_dump({
        "model": model_config, "dataset": {},
        "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1.0e-4}},
        "seed": 0, "num_train_epochs": 1,
    }))
    _, tiny = _tiny_kwargs("torch")
    tiny.pop("tokenizer")  # the server loads the vocab from its dir
    return work, tiny


@pytest.fixture
def tiny_constructor(monkeypatch, tiny_sdxl):
    """SDXLModel built at the checkpoint's tiny widths and in fp32 whatever
    config it is given (the CLI names only the checkpoint)."""
    work, tiny = tiny_sdxl
    config, _ = _tiny_kwargs("torch")
    build = SDXLModel.__init__

    def tiny_init(self, model_config, tokenizer=None):
        model_config = model_config.model_copy(update={"denoiser": config.denoiser,
                                                       "dtype": "float32"})
        build(self, model_config, tokenizer=tokenizer, **tiny)

    monkeypatch.setattr(SDXLModel, "__init__", tiny_init)
    return work


def _webp(image):
    buffer = io.BytesIO()
    image.save(buffer, format="WEBP")
    return buffer.getvalue()


def test_t2imodel_serves_a_tiny_sdxl_checkpoint(tiny_constructor):
    """T2IModel from the YAML behind both schedulers over HTTP: through the
    window batcher a seeded request's webp is the pipeline's own image of
    it, encoded alike; the continuous pool answers staggered requests of
    other step counts and refuses another size."""
    work = tiny_constructor
    served = T2IModel(str(work / "serve.yml"), None, str(work), family="sdxl", device="cpu")
    assert served.model.device == torch.device("cpu")
    direct = served.model.generate(["a cat"], negative_prompt=[srv.DEFAULT_NEGATIVE], width=64,
                                    height=64, num_inference_steps=2, cfg_scale=3.0, seed=5)
    batcher = MicroBatcher(served, max_batch=2, window_ms=60_000)
    server, port = _serving(batcher)
    try:
        _, ctype, data = _post(port, dict(prompt="a cat", width=64, height=64, inference_steps=2,
                                          cfg_scale=3.0, seed=5))
    finally:
        server.shutdown()
        server.server_close()
    assert ctype == "image/webp" and data == _webp(direct[0])

    sched = ContinuousScheduler(served, height=64, width=64, num_slots=2, max_steps=8)
    server, port = _serving(sched)
    try:
        responses = [None] * 2

        def post(i):
            responses[i] = _post(port, dict(prompt=f"cat {i}", width=64, height=64,
                                            inference_steps=2 + i, cfg_scale=3.0, seed=i))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        _join(threads)
        assert all(r[0] == 200 and r[1] == "image/webp" for r in responses)
        with pytest.raises(urllib.error.HTTPError) as off_pool:
            _post(port, {"prompt": "x", "width": 128, "height": 64})
        assert off_pool.value.code == 500
    finally:
        server.shutdown()
        server.server_close()
        sched.close()


def test_cli_writes_a_webp(tiny_constructor, tmp_path, capsys):
    """The CLI on the checkpoint with its denoiser's Linears in NF4 (the
    plain 4-bit matmul on the CPU), and a refused family by name."""
    work = tiny_constructor
    out = tmp_path / "out.webp"
    saved = inference_cli.main([
        "--family", "sdxl", "--checkpoint-path", str(work / "sdxl.safetensors"),
        "--tokenizer-path", str(work), "--width", "64", "--height", "64",
        "--num-inference-steps", "2", "--quant-type", "bnb_nf4", "--cfg-rescale", "0.5",
        "--save-path", str(out), "--device", "cpu",
    ])
    assert saved == [str(out)] and Image.open(out).format == "WEBP"
    assert Image.open(out).size == (64, 64)
    assert "Quantizing denoiser with bnb_nf4" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unsupported server family: 'sd3'"):
        inference_cli.main(["--family", "sd3", "--checkpoint-path", "x", "--device", "cpu"])


def test_cli_do_offloading_writes_the_plain_image(tiny_constructor, tmp_path):
    """``--do-offloading`` (which raised before offloading was ported) runs
    the staged request and writes the plain request's image."""
    work = tiny_constructor
    args = ["--family", "sdxl", "--checkpoint-path", str(work / "sdxl.safetensors"),
            "--tokenizer-path", str(work), "--width", "64", "--height", "64",
            "--num-inference-steps", "2", "--seed", "5", "--device", "cpu"]
    plain, staged = tmp_path / "plain.webp", tmp_path / "staged.webp"
    inference_cli.main([*args, "--save-path", str(plain)])
    inference_cli.main([*args, "--do-offloading", "--save-path", str(staged)])
    np.testing.assert_array_equal(np.asarray(Image.open(staged)), np.asarray(Image.open(plain)))


# -- CogView4 ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cogview4_file(tmp_path_factory):
    """A tiny CogView4's seeded weights in a single-file checkpoint, a YAML
    naming it and a SentencePiece vocab inside the tiny GLM's 256 ids."""
    work = tmp_path_factory.mktemp("tiny_cogview4")
    model = cogview4_tests.port_pipeline()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    st.save_file({k: v.contiguous() for k, v in model.state_dict().items()},
                 work / "cogview4.safetensors")
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [("\u2581" + w, -1.0 - 0.1 * i, 1) for i, w in enumerate(["a", "cat", "photo", "of"])]
    pieces += [(ch, -5.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz\u2581"]
    (work / "tokenizer.model").write_bytes(
        sentencepiece.serialize_model(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0))
    (work / "serve.yml").write_text(yaml.safe_dump({
        "model": {"checkpoint_path": str(work / "cogview4.safetensors"),
                  "denoiser": cogview4_tests.TINY},
        "dataset": {}, "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1.0e-4}},
        "seed": 0, "num_train_epochs": 1,
    }))
    return work


@pytest.fixture
def tiny_cogview4(monkeypatch, tiny_cogview4_file):
    """CogView4Model built at the checkpoint's tiny widths and in fp32
    whatever config it is given (the CLI and the tool name only the file)."""
    build = CogView4Model.__init__

    def tiny_init(self, config, tokenizer=None, **kwargs):
        config = config.model_copy(update={
            "dtype": "float32", "denoiser": CogView4DenoiserConfig(**cogview4_tests.TINY)})
        build(self, config, tokenizer=tokenizer,
              vae_config=AutoencoderKLConfig(**cogview4_tests.VAE),
              text_encoder_config=glm.GlmConfig(**cogview4_tests.GLM))

    monkeypatch.setattr(CogView4Model, "__init__", tiny_init)
    return tiny_cogview4_file


def test_t2imodel_serves_cogview4(tiny_cogview4):
    """T2IModel loads the checkpoint with the GLM tokenizer of its dir; a
    seeded window request is the pipeline's own image; the continuous
    scheduler takes a CogView4 pool."""
    work = tiny_cogview4
    served = T2IModel(str(work / "serve.yml"), None, str(work), family="cogview4", device="cpu")
    assert served.model.device == torch.device("cpu")
    assert served.model.text_encoder.tokenizer is not None
    params = GenerationParams(prompt="a photo of a cat", negative_prompt="", width=64, height=64,
                              inference_steps=2, cfg_scale=3.5, seed=5)
    got = served.generate_batch([params])
    want = served.model.generate(["a photo of a cat"], negative_prompt=[""], width=64, height=64,
                                 num_inference_steps=2, cfg_scale=3.5, seed=5)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    with pytest.raises(ValueError, match="Flux-only"):
        served.generate_batch([params.model_copy(update={"distilled_guidance": 2.0})])
    sched = ContinuousScheduler(served, height=64, width=64, num_slots=2, max_steps=4)
    try:
        image = sched.submit(params.model_copy(update={"inference_steps": 3}))
    finally:
        sched.close()
    assert image.size == (64, 64)


def test_cli_on_cogview4_in_nf4(tiny_cogview4, tmp_path, capsys):
    """The CLI quantizes the denoiser's Linears as the JAX tool does, but
    for CogView4's patch-in and patch-out projections, which the 4-bit
    kernel does not take; on the CPU the 4-bit matmul's plain version
    runs."""
    out = tmp_path / "out.webp"
    saved = inference_cli.main([
        "--family", "cogview4", "--checkpoint-path", str(tiny_cogview4 / "cogview4.safetensors"),
        "--tokenizer-path", str(tiny_cogview4), "--width", "32", "--height", "32",
        "--num-inference-steps", "2", "--cfg-scale", "3.5", "--quant-type", "bnb_nf4",
        "--save-path", str(out), "--device", "cpu",
    ])
    assert saved == [str(out)] and Image.open(out).size == (32, 32)
    assert "Quantizing denoiser with bnb_nf4" in capsys.readouterr().out
    model = inference_cli.build_model("cogview4", str(tiny_cogview4 / "cogview4.safetensors"),
                                      str(tiny_cogview4), "bnb_nf4", device="cpu")
    layers = {n: m for n, m in model.denoiser.named_modules() if hasattr(m, "in_features")}
    unquantized = {n for n, m in layers.items() if not m.is_quantized}
    assert unquantized == {"patch_embed.proj", "proj_out"}
    assert all(m.quantized_name == n for n, m in layers.items() if m.is_quantized)


def _full_size_linears(family):
    """The Linears, by name, of the family's published-size denoiser (for
    "cogview4_tool": the whole CogView4 pipeline, GLM included), on meta."""
    import importlib

    if family == "cogview4_tool":
        model = CogView4Model(cogview4_tests.cv_config.CogView4Config(checkpoint_path=""),
                              tokenizer=cogview4_tests.GlmTok())
        module = model.as_module()
    else:
        config = importlib.import_module(f"vision_ft_tpu_torch.models.{family}.config")
        denoiser = importlib.import_module(f"vision_ft_tpu_torch.models.{family}.denoiser")
        kwargs = {"type": "flux1-dev"} if family == "flux" else {}
        with torch.device("meta"):
            module = denoiser.Denoiser(config.DenoiserConfig(**kwargs))
    return {n: m for n, m in module.named_modules() if hasattr(m, "in_features")}


@pytest.mark.parametrize("family", [*inference_cli.UNQUANTIZED, "cogview4_tool"])
def test_quantized_layers_are_the_4bit_kernels_shapes(family):
    """At published widths every Linear the CLI (or the CogView4 quant
    tool, both groups) quantizes is one the 4-bit kernel takes, so none
    raises on the card's "fused" route; and the CLI leaves out no more."""
    from vision_ft_tpu_torch.ops import nf4_matmul
    from vision_ft_tpu_torch.utils.state_dict import get_target_keys

    layers = _full_size_linears(family)
    if family == "cogview4_tool":
        quantized = set()
        for include, exclude in (cogview4_quant_compare.TEXT_ENCODER_KEYS,
                                 cogview4_quant_compare.DENOISER_KEYS):
            quantized.update(get_target_keys(include, exclude, list(layers)))
        assert len(quantized) == 40 * 6 + 28 * 6  # GLM's 40 layers, the DiT's 28 blocks
    else:
        quantized = set(get_target_keys(
            [""], [*inference_cli.EXCLUDE_KEYS, *inference_cli.UNQUANTIZED[family]], list(layers)))
        jax_tool = set(get_target_keys([""], inference_cli.EXCLUDE_KEYS, list(layers)))
        assert all(not nf4_matmul.supports(1, layers[n].in_features, layers[n].out_features, 64)
                   for n in jax_tool - quantized)
    assert quantized and all(
        nf4_matmul.supports(1, layers[n].in_features, layers[n].out_features, 64)
        for n in quantized)


def test_cogview4_quant_compare_tool(tiny_cogview4, tmp_path, capsys):
    """The port's quant-compare tool: the JAX tool's groups (GLM's
    projections and MLP, the DiT's attention and feed-forward), the webp and
    the JSON report."""
    common = ["--model_path", str(tiny_cogview4 / "cogview4.safetensors"), "--tokenizer_path",
              str(tiny_cogview4), "--height", "32", "--width", "32", "--num_inference_steps", "2",
              "--output_dir", str(tmp_path), "--device", "cpu"]
    before = nf4_matmul_forward.launches
    report = cogview4_quant_compare.main([*common, "--text_encoder", "bnb_nf4",
                                          "--denoiser", "bnb_nf4"])
    assert nf4_matmul_forward.launches == before  # the CPU takes the plain version
    run = "text-encoder-bnb_nf4_denoiser-bnb_nf4"
    assert report["run"] == run and report["peak_bytes_in_use"] is None
    # GLM: 2 layers x (4 projections + 2 MLP); the DiT: 2 blocks x 6
    assert report["quantized_layers"] == 2 * 6 + 2 * 6
    assert json.loads((tmp_path / f"{run}.json").read_text()) == report
    assert Image.open(tmp_path / f"{run}.webp").size == (32, 32)
    plain = cogview4_quant_compare.main(common)
    assert plain["quantized_layers"] == 0 and plain["run"] == "text-encoder-bf16_denoiser-bf16"

    model = cogview4_tests.port_pipeline()
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    names = cogview4_quant_compare.quantize_model(model, "bnb_nf4", "bf16")
    assert all(n.startswith("text_encoder.") for n in names) and len(names) == 12


def test_client_posts_and_saves(tmp_path, capsys):
    clock = FakeClock()
    batcher = MicroBatcher(StubModel(), max_batch=1, window_ms=1000, clock=clock)
    server, port = _serving(batcher)
    try:
        out = tmp_path / "client.webp"
        seconds = inference_client.main([
            "--url", f"http://127.0.0.1:{port}/predict", "--prompt", "a cat", "--width", "128",
            "--height", "64", "--seed", "3", "--save-path", str(out)])
    finally:
        server.shutdown()
        server.server_close()
    assert seconds > 0 and Image.open(out).size == (128, 64)
    assert f"Saved {out}" in capsys.readouterr().out


# -- wan: frames, video replies, a tiny three-file checkpoint ---------------------------


def test_wan_frames_reach_generate_with_a_default():
    """A wan request's ``frames`` reaches generate(), 16 where it names
    none; the image families refuse it."""
    wan, calls = _stub_t2i("wan")
    wan.generate_batch([GenerationParams(prompt="x", width=64, height=64)])
    assert calls["frames"] == srv.WAN_DEFAULT_FRAMES == 16
    wan.generate_batch([GenerationParams(prompt="x", width=64, height=64, frames=9, seed=2)])
    assert calls["frames"] == 9 and calls["seed"] == 2
    for family in ("sdxl", "lumina2", "auraflow", "cogview4", "flux"):
        model, _ = _stub_t2i(family)
        with pytest.raises(ValueError, match="Wan-only"):
            model.generate_batch([GenerationParams(prompt="x", width=64, height=64, frames=8)])
    assert batch_key(GenerationParams(prompt="a", frames=8)) != batch_key(
        GenerationParams(prompt="a", frames=16))


def test_continuous_scheduler_refuses_wan():
    """As in the JAX package, wan runs on the window scheduler only."""
    wan, _ = _stub_t2i("wan")
    with pytest.raises(ValueError, match="currently serves"):
        ContinuousScheduler(wan, height=64, width=64)


class StubVideoModel:
    """Replies with one list of frames a request."""

    def generate_batch(self, batch):
        return [[Image.new("RGB", (p.width, p.height), (40 * i, 0, 0)) for i in range(p.frames)]
                for p in batch]


def _mp4_frames(data, tmp_path):
    import cv2

    path = tmp_path / "reply.mp4"
    path.write_bytes(data)
    capture = cv2.VideoCapture(str(path))
    fps, frames = capture.get(cv2.CAP_PROP_FPS), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return fps, frames


def test_handler_answers_video_mp4_for_frames(tmp_path):
    """A list of frames goes back as an mp4 at the request's fps."""
    batcher = MicroBatcher(StubVideoModel(), max_batch=1, window_ms=0)
    server, port = _serving(batcher)
    try:
        status, ctype, data = _post(port, {"prompt": "x", "width": 64, "height": 128,
                                           "frames": 5, "fps": 8})
    finally:
        server.shutdown()
        server.server_close()
    assert status == 200 and ctype == "video/mp4"
    fps, frames = _mp4_frames(data, tmp_path)
    assert fps == 8 and len(frames) == 5 and frames[0].shape == (128, 64, 3)


@pytest.fixture(scope="module")
def tiny_wan_files(tmp_path_factory):
    """A tiny Wan's seeded weights in its three files, a YAML naming them
    and a SentencePiece vocab inside the tiny UMT5's 64 ids."""
    work = tmp_path_factory.mktemp("tiny_wan")
    model = _tiny_wan(work)
    model.init_params(torch.Generator().manual_seed(0), device="cpu")
    model.vae.init_random(torch.Generator().manual_seed(1), "cpu")
    st.save_file(model.denoiser_state_dict(), work / "denoiser.safetensors")
    st.save_file(model.text_encoder_state_dict(), work / "text_encoder.safetensors")
    st.save_file(model.vae.state_dict(), work / "vae.safetensors")
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    pieces += [("\u2581" + w, -1.0 - 0.1 * i, 1) for i, w in enumerate(["a", "cat", "photo", "of"])]
    pieces += [(ch, -5.0, 1) for ch in "abcdefghijklmnopqrstuvwxyz\u2581"]
    (work / "tokenizer.model").write_bytes(
        sentencepiece.serialize_model(pieces, unk_id=2, bos_id=-1, eos_id=1, pad_id=0))
    (work / "serve.yml").write_text(yaml.safe_dump({
        "model": {"denoiser_path": str(work / "denoiser.safetensors"),
                  "text_encoder_path": str(work / "text_encoder.safetensors"),
                  "vae_path": str(work / "vae.safetensors"), "dtype": "float32"},
        "dataset": {}, "optimizer": {"name": "torch.optim.AdamW", "args": {"lr": 1.0e-4}},
        "seed": 0, "num_train_epochs": 1,
    }))
    return work


def _tiny_wan(work):
    from vision_ft_tpu_torch.models.wan import WanConfig

    return Wan22(WanConfig(denoiser_path=str(work / "denoiser.safetensors"),
                           text_encoder_path=str(work / "text_encoder.safetensors"),
                           vae_path=str(work / "vae.safetensors"), dtype="float32",
                           denoiser=_TINY_WAN_DENOISER),
                 tokenizer=wan_tests.Tok(), text_encoder_config=WanT5Config(**wan_tests.TINY_T5),
                 vae=_tiny_wan_vae())


_TINY_WAN_DENOISER = WanDenoiserConfig(**dict(wan_tests.TINY, in_channels=4, out_channels=4,
                                              text_dim=32))


def _tiny_wan_vae():
    with torch.device("meta"):
        return CausalVAE(WanVAEConfig(**wan_tests.TINY_VAE))


@pytest.fixture
def tiny_wan(monkeypatch, tiny_wan_files):
    """Wan22 built at the files' tiny widths and in fp32 whatever config it
    is given (the CLI names only the denoiser's file)."""
    build = Wan22.__init__

    def tiny_init(self, config, tokenizer=None, **kwargs):
        config = config.model_copy(update={"dtype": "float32", "denoiser": _TINY_WAN_DENOISER})
        build(self, config, tokenizer=tokenizer,
              text_encoder_config=WanT5Config(**wan_tests.TINY_T5), vae=_tiny_wan_vae())

    monkeypatch.setattr(Wan22, "__init__", tiny_init)
    return tiny_wan_files


def test_t2imodel_serves_wan(tiny_wan, tmp_path):
    """T2IModel loads the three files named by the YAML with the T5
    tokenizer of its dir; two compatible requests with ``frames`` share one
    generate() of batch 2, each its batch-1 result; the reply is an mp4."""
    work = tiny_wan
    served = T2IModel(str(work / "serve.yml"), None, str(work), family="wan", device="cpu")
    assert served.model.device == torch.device("cpu")
    assert served.model.text_encoder.tokenizer is not None
    calls = []
    generate = served.model.generate

    def counted(**kwargs):
        calls.append(len(kwargs["prompt"]))
        return generate(**kwargs)

    served.model.generate = counted
    batcher = MicroBatcher(served, max_batch=2, window_ms=5000, pad_to_bucket=False)
    server, port = _serving(batcher)
    bodies = [dict(prompt=p, negative_prompt="", width=64, height=64, frames=8, fps=4,
                   inference_steps=2, cfg_scale=5.0) for p in ("a photo of a cat", "a cat")]
    replies = [None, None]

    def post(i):
        replies[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
    try:
        for th in threads:
            th.start()
        _join(threads)
    finally:
        server.shutdown()
        server.server_close()
    assert calls == [2]
    for (status, ctype, data), body in zip(replies, bodies):
        assert status == 200 and ctype == "video/mp4"
        fps, frames = _mp4_frames(data, tmp_path)
        assert fps == 4 and len(frames) == 5 and frames[0].shape == (64, 64, 3)
    group = [GenerationParams(**body, seed=7) for body in bodies]
    together = served.generate_batch(group)
    for row, (params, video) in enumerate(zip(group, together)):
        # row i of a batch draws its noise from seed + i
        alone = generate(params.prompt, negative_prompt=[""], frames=8, width=64, height=64,
                         num_inference_steps=2, cfg_scale=5.0, seed=7 + row)
        got = np.stack([np.asarray(im, np.int16) for im in video])
        want = np.stack([np.asarray(im, np.int16) for im in alone[0]])
        assert got.shape == (5, 64, 64, 3) and np.abs(got - want).max() <= 1


@pytest.mark.parametrize("quant", [None, "bnb_nf4"])
def test_cli_on_wan_writes_an_mp4(tiny_wan, tmp_path, capsys, quant):
    """The CLI reads the denoiser's file and its two siblings and writes an
    mp4 of --frames frames at --fps; with --quant-type every denoiser
    Linear but the 192-wide head is quantized (the CPU takes the 4-bit
    matmul's plain version)."""
    import cv2

    out = tmp_path / "out.mp4"
    args = ["--family", "wan", "--checkpoint-path", str(tiny_wan / "denoiser.safetensors"),
            "--tokenizer-path", str(tiny_wan), "--width", "32", "--height", "32",
            "--num-inference-steps", "2", "--frames", "8", "--fps", "6", "--save-path", str(out),
            "--device", "cpu"]
    before = nf4_matmul_forward.launches
    saved = inference_cli.main(args + (["--quant-type", quant] if quant else []))
    assert nf4_matmul_forward.launches == before
    assert saved == [str(out)]
    capture = cv2.VideoCapture(str(out))
    assert capture.get(cv2.CAP_PROP_FRAME_COUNT) == 5 and capture.get(cv2.CAP_PROP_FPS) == 6
    capture.release()
    if quant:
        assert "Quantizing denoiser with bnb_nf4" in capsys.readouterr().out
        model = inference_cli.build_model("wan", str(tiny_wan / "denoiser.safetensors"),
                                          str(tiny_wan), quant, device="cpu")
        layers = {n: m for n, m in model.denoiser.named_modules() if hasattr(m, "in_features")}
        assert {n for n, m in layers.items() if not m.is_quantized} == {"head.head"}
    assert inference_cli.model_config("wan", "/x/denoiser.safetensors") == {
        "denoiser_path": "/x/denoiser.safetensors",
        "text_encoder_path": "/x/text_encoder.safetensors", "vae_path": "/x/vae.safetensors"}


def test_t2imodel_loads_a_wan_lora_into_the_denoiser(tiny_wan, tmp_path):
    """A LoRA file in the denoiser file's keys (``model.`` first) goes onto
    the DiT's Linears, as the JAX server converts it."""
    rng = np.random.default_rng(0)
    lora = {"model.blocks.0.self_attn.q.lora_down.weight": rng.standard_normal((4, 64)),
            "model.blocks.0.self_attn.q.lora_up.weight": rng.standard_normal((64, 4)),
            "model.blocks.0.self_attn.q.alpha": np.array(4.0)}
    path = tmp_path / "lora.safetensors"
    st.save_file({k: torch.tensor(v, dtype=torch.float32) for k, v in lora.items()}, path)
    served = T2IModel(str(tiny_wan / "serve.yml"), str(path), str(tiny_wan), family="wan",
                      device="cpu")
    q = served.model.denoiser.blocks[0].self_attn.q
    np.testing.assert_array_equal(q.lora_down.weight.detach().numpy(),
                                  lora["model.blocks.0.self_attn.q.lora_down.weight"]
                                  .astype(np.float32))
    assert float(q.alpha) == 4.0
