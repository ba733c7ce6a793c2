"""The port's OpenAI grounding backend with a stub client (mirrors
``tests/test_openai_backend.py``): ``<image>``-tag interleaving, ``detail:
low`` base64 frames, retries, strict and reference-style errors, and the
``gpt`` route of ``UniversalGrounder``.  The ``openai`` module is a stub
put in ``sys.modules``; no test reaches the network.
"""

import sys
import types

import numpy as np
import pytest


class _FakeCompletions:
    def __init__(self, script):
        self.script = list(script)  # items: Exception or str
        self.calls = []

    def create(self, **kwargs):
        self.calls.append(kwargs)
        action = self.script.pop(0)
        if isinstance(action, Exception):
            raise action
        msg = types.SimpleNamespace(content=action)
        return types.SimpleNamespace(choices=[types.SimpleNamespace(message=msg)])


class _FakeClient:
    def __init__(self, script):
        self.chat = types.SimpleNamespace(completions=_FakeCompletions(script))


def fake_openai_module(monkeypatch, client=None):
    fake_openai = types.ModuleType("openai")
    fake_openai.OpenAI = lambda api_key=None: client or types.SimpleNamespace()
    monkeypatch.setitem(sys.modules, "openai", fake_openai)


@pytest.fixture()
def backend_factory(monkeypatch):
    fake_openai_module(monkeypatch)
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    from tstar_tpu_torch.grounding.openai_backend import OpenAIBackend

    def make(script, **kw):
        b = OpenAIBackend(retry_backoff=0.0, **kw)
        b._client = _FakeClient(script)
        return b

    return make


FRAME = np.full((8, 8, 3), 128, np.uint8)


class TestInterleave:
    def test_image_tags_interleave_text_and_frames(self, backend_factory):
        b = backend_factory(["ok"])
        b.inference_with_frames("Look at <image> and <image> then answer.", [FRAME, FRAME])
        content = b._client.chat.completions.calls[0]["messages"][1]["content"]
        assert [p["type"] for p in content] == ["text", "image_url", "text", "image_url", "text"]
        assert content[0]["text"] == "Look at" and content[2]["text"] == "and"
        img = content[1]["image_url"]
        assert img["detail"] == "low"
        assert img["url"].startswith("data:image/jpeg;base64,")

    def test_no_tags_appends_frames(self, backend_factory):
        b = backend_factory(["ok"])
        b.inference_with_frames("Describe.", [FRAME])
        content = b._client.chat.completions.calls[0]["messages"][1]["content"]
        assert [p["type"] for p in content] == ["text", "image_url"]

    def test_system_message_and_model_threaded(self, backend_factory):
        b = backend_factory(["fine"])
        out = b.inference_text_only("hello", system_message="sys", temperature=0.2)
        call = b._client.chat.completions.calls[0]
        assert out == "fine" and call["model"] == "gpt-4o"
        assert call["messages"][0] == {"role": "system", "content": "sys"}
        assert call["temperature"] == 0.2


class TestRetriesAndErrors:
    def test_retries_then_succeeds(self, backend_factory):
        b = backend_factory([RuntimeError("503"), RuntimeError("503"), "  answer  "])
        assert b.inference_text_only("q") == "answer"
        assert len(b._client.chat.completions.calls) == 3

    def test_strict_raises_typed_error_after_retries(self, backend_factory):
        from tstar_tpu_torch.grounding.openai_backend import OpenAIBackendError

        b = backend_factory([RuntimeError("boom")] * 3)
        with pytest.raises(OpenAIBackendError, match="boom"):
            b.inference_text_only("q")
        assert len(b._client.chat.completions.calls) == 3

    def test_reference_mode_swallows_into_error_string(self, backend_factory):
        b = backend_factory([RuntimeError("boom")] * 3, strict=False)
        out = b.inference_text_only("q")
        assert out.startswith("Error:") and "boom" in out

    def test_missing_api_key_raises(self, monkeypatch):
        fake_openai_module(monkeypatch)
        monkeypatch.delenv("OPENAI_API_KEY", raising=False)
        from tstar_tpu_torch.grounding.openai_backend import OpenAIBackend

        with pytest.raises(ValueError, match="OPENAI_API_KEY"):
            OpenAIBackend()


def test_same_request_as_reference(monkeypatch):
    """The port's backend sends the reference's request for the same query
    and frames (the JPEG bytes included)."""
    fake_openai_module(monkeypatch)
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    from tstar_tpu.grounding.openai_backend import OpenAIBackend as JBackend
    from tstar_tpu_torch.grounding.openai_backend import OpenAIBackend

    frames = [np.random.default_rng(i).integers(0, 256, (16, 24, 3), np.uint8) for i in range(2)]
    calls = []
    for cls in (JBackend, OpenAIBackend):
        b = cls(retry_backoff=0.0)
        b._client = _FakeClient(["a"])
        b.inference_with_frames("One <image> two <image>", frames, temperature=0.0, max_tokens=7)
        calls.append(b._client.chat.completions.calls[0])
    assert calls[0] == calls[1]


def test_universal_grounder_gpt_route(monkeypatch):
    """``UniversalGrounder('gpt-4o')`` builds the OpenAI backend (the key from
    the environment) and grounds and answers through it."""
    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.video.synthetic import default_scene

    client = _FakeClient(["couch, lamp\ntv", " B "])
    fake_openai_module(monkeypatch, client)
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    g = UniversalGrounder("gpt-4o")
    assert type(g.backend).__name__ == "OpenAIBackend" and g.backend.model_name == "gpt-4o"
    targets, cues = g.inference_query_grounding("mem://v", "Where?", "A) x",
                                                decoder=default_scene(60.0, hw=(36, 64)))
    assert (targets, cues) == (["couch", "lamp"], ["tv"])
    assert g.inference_qa([FRAME], "Where?", "A) x\nB) y") == "B"
    first = client.chat.completions.calls[0]["messages"][1]["content"]
    assert sum(p["type"] == "image_url" for p in first) == 8
    assert client.chat.completions.calls[1]["max_tokens"] == 30
