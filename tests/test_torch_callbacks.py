"""The port's trackers, Hugging Face Hub saving callback and Discord
preview callback against the JAX package's, through fake ``wandb``,
``torch.utils.tensorboard`` and ``huggingface_hub`` modules, the port's
Hub client injected, and the
webhook a local HTTP server: no request leaves the machine.
"""

import email.parser
import http.server
import sys
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

from vision_ft_tpu.preview.discord import DiscordWebhookPreviewCallback as JaxDiscord
from vision_ft_tpu.preview.discord import DiscordWebhookPreviewCallbackConfig as JaxDiscordConfig
from vision_ft_tpu.saving import HFHubSavingCallbackConfig as JaxHubConfig
from vision_ft_tpu.saving import get_saving_callback as jax_get_saving_callback
from vision_ft_tpu.utils.logging import Trackers as JaxTrackers

from vision_ft_tpu_torch.preview import (
    DiscordWebhookPreviewCallback,
    DiscordWebhookPreviewCallbackConfig,
    get_preview_callback,
)
from vision_ft_tpu_torch.saving import HFHubSavingCallbackConfig, get_saving_callback
from vision_ft_tpu_torch.utils import safetensors as st
from vision_ft_tpu_torch.utils.logging import Trackers
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


class Recorder:
    """Records every method call as (name, args, kwargs)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args, **kwargs: self.calls.append((name, args, kwargs))


VALUES = [({"train/loss": 0.5, "lr": 1e-4, "note": "text", "n": 3}, 1), ({"train/loss": 0.25}, 2)]


def _fake_tracker_modules(monkeypatch, runs, writers):
    wandb = types.ModuleType("wandb")
    wandb.init = lambda project, config: runs.append(Recorder()) or runs[-1]
    tensorboard = types.ModuleType("torch.utils.tensorboard")

    def writer(log_dir):
        writers.append(Recorder())
        writers[-1].log_dir = log_dir
        return writers[-1]

    tensorboard.SummaryWriter = writer
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tensorboard)


def test_trackers_log_as_jax(monkeypatch):
    """wandb gets ``log(values, step=...)``, tensorboard an ``add_scalar``
    per int or float value; ``finish`` ends both: the same calls as the
    JAX package's through the same (fake) packages."""
    runs, writers = [], []
    _fake_tracker_modules(monkeypatch, runs, writers)
    jax_trackers = JaxTrackers(["wandb", "tensorboard"], "proj", {"a": 1})
    ours = Trackers(["wandb", "tensorboard"], "proj", {"a": 1})
    for trackers in (jax_trackers, ours):
        for values, step in VALUES:
            trackers.log(values, step=step)
        trackers.finish()
    assert len(runs) == len(writers) == 2
    assert writers[0].log_dir == writers[1].log_dir == "runs/proj"
    for want, got in ((runs[0], runs[1]), (writers[0], writers[1])):
        assert got.calls == want.calls
    assert [c[1][0] for c in writers[1].calls if c[0] == "add_scalar"] == [
        "train/loss", "lr", "n", "train/loss"]


def test_missing_tracker_packages_warn_and_log_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.warns(UserWarning) as caught:
        trackers = Trackers(["wandb", "tensorboard"], "proj", {})
    assert [str(w.message).split(" ")[0] for w in caught] == ["wandb", "tensorboard"]
    trackers.log({"x": 1.0}, step=0)
    trackers.finish()
    with pytest.raises(ValueError):
        Trackers(["mlflow"], "proj", {})


def test_real_tensorboard_writer_where_installed(monkeypatch, tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    monkeypatch.chdir(tmp_path)
    trackers = Trackers(["tensorboard"], "proj", {})
    trackers.log({"train/loss": 0.5}, step=3)
    trackers.finish()
    assert any((tmp_path / "runs" / "proj").iterdir())


def _state_dict():
    rng = np.random.default_rng(0)
    return {"lora.down.weight": rng.standard_normal((4, 8)).astype(np.float32),
            "lora.alpha": np.full((), 4.0, np.float32)}


def test_hf_hub_callback_saves_then_uploads_as_jax(monkeypatch, tmp_path):
    """The saved file and the ``upload_file`` call equal the JAX
    callback's (its ``HfApi`` a recorder in a fake ``huggingface_hub``)."""
    jax_api = Recorder()
    hub = types.ModuleType("huggingface_hub")
    hub.HfApi = lambda: jax_api
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    fields = dict(name="lora", hub_id="me/repo", dir_in_repo="ckpt", repo_type="model")
    jax_cb = jax_get_saving_callback(JaxHubConfig(save_dir=str(tmp_path / "jax"), **fields))
    api = Recorder()
    ours = get_saving_callback(HFHubSavingCallbackConfig(save_dir=str(tmp_path / "port"), **fields),
                               api=api)
    state = _state_dict()
    want_path = jax_cb.save_state_dict(state, 2, 30, metadata={"k": "v"})
    got_path = ours.save_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, 2, 30,
                                    metadata={"k": "v"})
    assert got_path.name == want_path.name == "lora_00002e_000030s.safetensors"
    (_, _, want_kw), = jax_api.calls
    (name, _, got_kw), = api.calls
    assert name == "upload_file"
    assert got_kw == {**want_kw, "path_or_fileobj": got_path}
    assert got_kw["path_in_repo"] == "ckpt/lora_00002e_000030s.safetensors"
    want, got = st.load_file(want_path), st.load_file(got_path)
    assert sorted(want) == sorted(got)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_hf_hub_callback_without_the_package_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    config = HFHubSavingCallbackConfig(name="x", save_dir=str(tmp_path), hub_id="me/repo",
                                       dir_in_repo="d")
    with pytest.raises(ImportError, match="huggingface_hub"):
        get_saving_callback(config)


class _Webhook:
    """A local HTTP server that records each POST (headers, body) and
    replies ``status``."""

    def __init__(self, status=204):
        posts = self.posts = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                posts.append((self.headers["Content-Type"], body))
                self.send_response(status)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/webhook"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def parse_multipart(content_type: str, body: bytes) -> dict:
    """{field: value} of a multipart/form-data body; a file field's value
    is (file name, content type, bytes)."""
    message = email.parser.BytesParser().parsebytes(
        f"Content-Type: {content_type}\r\n\r\n".encode() + body)
    out = {}
    for part in message.get_payload():
        name = part.get_param("name", header="content-disposition")
        data = part.get_payload(decode=True)
        file_name = part.get_filename()
        out[name] = (file_name, part.get_content_type(), data) if file_name else data.decode()
    return out


def _images():
    rng = np.random.default_rng(1)
    return [Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)) for _ in range(2)]


def test_discord_post_parses_to_jax_body_and_files():
    """The port's POST, parsed, holds the JAX callback's ``compose_body``
    fields and ``prepare_files`` files (the same webp bytes) and equals the
    JAX callback's own POST (through ``requests``) parsed."""
    pytest.importorskip("requests")
    hook = _Webhook()
    try:
        fields = dict(url=hook.url, username="trainer")
        jax_cb = JaxDiscord(JaxDiscordConfig(**fields))
        ours = get_preview_callback(DiscordWebhookPreviewCallbackConfig(**fields))
        assert isinstance(ours, DiscordWebhookPreviewCallback)
        images, metadata = _images(), {"prompt": "a cat"}
        jax_cb.preview_image(images, 1, 20, 0, metadata=metadata)
        ours.preview_image(images, 1, 20, 0, metadata=metadata)
    finally:
        hook.close()
    want, got = (parse_multipart(*post) for post in hook.posts)
    assert got == want
    body = jax_cb.compose_body(1, 20, 0, caption="a cat")
    files = jax_cb.prepare_files(images)
    assert {k: v for k, v in got.items() if not k.startswith("file")} == body
    assert "Caption" in got["content"] and got["username"] == "trainer"
    for name, (file_name, file, content_type) in files.items():
        assert got[name] == (file_name, content_type, file.read())
    assert sorted(k for k in got if k.startswith("file")) == ["file0", "file1"]


def test_discord_raises_on_an_error_reply():
    hook = _Webhook(status=500)
    try:
        ours = DiscordWebhookPreviewCallback(DiscordWebhookPreviewCallbackConfig(url=hook.url))
        with pytest.raises(OSError):
            ours.preview_image(_images()[:1], 0, 1, 0)
    finally:
        hook.close()
    assert len(hook.posts) == 1
