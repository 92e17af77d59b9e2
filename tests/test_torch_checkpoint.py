"""Port parity: ColPali checkpoints in and out (colpali_tpu_torch against
colpali_tpu): the safetensors reader and writer, ``load_colpali_params`` /
``export_colpali_state_dict`` / ``save_pretrained`` both ways,
``load_retriever`` on ``scripts/validate_checkpoint.py::make_synth_colpali``'s
offline checkpoint, and ``serve --checkpoint``.

Parameters crossing between the packages are compared bit for bit. The
two ``load_retriever`` results are compared in fp32 on the CPU at atol=2e-5
(page embeddings) and 1e-5 (queries): the same arithmetic summed in another
order by XLA and by PyTorch, as for the forward in test_torch_colpali.py;
pixels come from each package's own device resize (within 6e-6 of each
other on these upscaled pages, test_torch_processor_surface.py).
"""

import json
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as sf_load_file
from safetensors.numpy import save_file as sf_save_file

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu.auto import detect_family as jax_detect_family  # noqa: E402
from colpali_tpu.auto import load_retriever as jax_load_retriever  # noqa: E402
from colpali_tpu.core.hf_loader import load_colpali_params as jax_load_colpali_params  # noqa: E402
from colpali_tpu.models.configs import PaliGemmaConfig  # noqa: E402
from colpali_tpu.models.paligemma import ColPali as JaxColPali  # noqa: E402
from colpali_tpu.training.checkpointing import save_pretrained as jax_save_pretrained  # noqa: E402
from colpali_tpu_torch import serve  # noqa: E402
from colpali_tpu_torch.auto import _PORTED, detect_family, exporter_for, load_retriever  # noqa: E402
from colpali_tpu_torch.core import safetensors  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.core.hf_export import export_colpali_state_dict  # noqa: E402
from colpali_tpu_torch.core.hf_loader import load_colpali_params  # noqa: E402
from colpali_tpu_torch.training.checkpointing import save_pretrained  # noqa: E402

QUERIES = ["find document page 0 quarterly report", "what is the total revenue ?"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import validate_checkpoint as vc

    path = tmp_path_factory.mktemp("synth") / "colpali-tiny"
    init = JaxColPali.init
    JaxColPali.init = lambda self, rng, *args: jax.jit(lambda r, *a: init(self, r, *a))(rng, *args)  # the same init, compiled
    try:
        vc.make_synth_colpali(str(path))
    finally:
        JaxColPali.init = init
    return str(path)


@pytest.fixture(scope="module")
def seeded_bf16(ckpt):
    """One seeded set of bf16 ColPali weights (the synthetic checkpoint's,
    rounded to bf16): the JAX tree and its state dict in the port."""
    from colpali_tpu.core.hf_loader import load_hf_config

    model = JaxColPali(PaliGemmaConfig.from_hf_config(load_hf_config(ckpt)), dim=128)
    params = jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16), jax_load_colpali_params(ckpt))
    return model, params, state_dict_from_jax(params)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["BF16", "F16", "F32", "I8", "I32", "I64"])
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    rng = np.random.default_rng(0)
    np_dtype = {"BF16": ml_dtypes.bfloat16, "F16": np.float16, "F32": np.float32, "I8": np.int8, "I32": np.int32,
                "I64": np.int64}[dtype]
    arrays = {"w": (rng.normal(size=(3, 5)) * 50).astype(np_dtype), "empty": np.zeros((0, 2), np_dtype),
              "scalar": np.asarray(7, np_dtype), "v": (rng.normal(size=(9,)) * 50).astype(np_dtype)}
    sf_save_file(arrays, str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
    ours = safetensors.load_file(str(tmp_path / "theirs.safetensors"))
    assert set(ours) == set(arrays) and safetensors.read_metadata(str(tmp_path / "theirs.safetensors")) == {
        "format": "pt"}
    for name, want in arrays.items():
        assert ours[name].dtype == safetensors.DTYPES[dtype] and tuple(ours[name].shape) == want.shape
        np.testing.assert_array_equal(_bits(ours[name]), _bits(want))
    safetensors.save_file(ours, str(tmp_path / "ours.safetensors"), metadata={"format": "pt"})
    back = sf_load_file(str(tmp_path / "ours.safetensors"))
    for name, want in arrays.items():
        assert back[name].dtype == want.dtype and back[name].shape == want.shape
        np.testing.assert_array_equal(_bits(back[name]), _bits(want))


def test_safetensors_reader_rejects_a_short_file(tmp_path):
    safetensors.save_file({"w": torch.ones(4)}, str(tmp_path / "x.safetensors"))
    data = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "x.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError, match="past the file's end"):
        safetensors.load_file(str(tmp_path / "x.safetensors"))


def test_jax_reads_the_ports_export_bit_for_bit(tmp_path, seeded_bf16):
    model, params, state = seeded_bf16
    save_pretrained(str(tmp_path), state, config=model.config)
    assert json.load(open(tmp_path / "training_provenance.json"))["checkpoint_layout"] == "hf"
    assert json.load(open(tmp_path / "config.json"))["text"]["hidden_size"] == 32  # JAX's asdict, not HF
    loaded = dict(_flatten(jax_load_colpali_params(str(tmp_path))))
    want = dict(_flatten(params))
    assert loaded.keys() == want.keys()
    for path, leaf in want.items():
        got = np.asarray(loaded[path])
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(_bits(got), _bits(leaf), err_msg=path)


def test_port_reads_the_jax_export_bit_for_bit(tmp_path, seeded_bf16):
    model, params, state = seeded_bf16
    jax_save_pretrained(str(tmp_path), params, config=model.config, model=model)
    loaded = load_colpali_params(str(tmp_path))
    assert loaded.keys() == state.keys()
    for name, want in state.items():
        assert loaded[name].dtype == want.dtype and loaded[name].shape == want.shape, name
        np.testing.assert_array_equal(_bits(loaded[name]), _bits(want), err_msg=name)
    # and the port's own export carries the same keys and bytes as JAX's
    ours = export_colpali_state_dict(state)
    theirs = sf_load_file(str(tmp_path / "model.safetensors"))
    assert ours.keys() == theirs.keys()
    for key, value in theirs.items():
        np.testing.assert_array_equal(_bits(ours[key]), _bits(value), err_msg=key)


def test_loader_is_strict_and_drops_what_jax_drops(ckpt):
    state = safetensors.load_file(f"{ckpt}/model.safetensors")
    from colpali_tpu_torch.core.hf_loader import PALIGEMMA_KEY_REMAPS, PALIGEMMA_RULES, convert_state_dict

    extra = {**{f"base_model.model.{k}": v for k, v in state.items()}, "lm_head.weight": torch.zeros(2),
             "model.language_model.layers.0.self_attn.q_proj.lora_A.weight": torch.zeros(2)}
    converted = convert_state_dict(extra, PALIGEMMA_RULES, PALIGEMMA_KEY_REMAPS)
    assert converted.keys() == load_colpali_params(ckpt).keys()
    with pytest.raises(ValueError, match="Unmatched checkpoint keys"):
        convert_state_dict({**state, "model.mystery.weight": torch.zeros(1)}, PALIGEMMA_RULES)


def test_load_retriever_matches_jax(ckpt):
    jax_model, variables, jax_proc = jax_load_retriever(ckpt, family="colpali", dtype=jnp.float32,
                                                        param_dtype=jnp.float32)
    model, proc = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    assert proc.image_size == 28 and proc.image_seq_length == 4
    q, jq = proc.process_queries(QUERIES), jax_proc.process_queries(QUERIES)
    np.testing.assert_array_equal(q["input_ids"], jq["input_ids"])
    pages = [np.random.default_rng(s).integers(0, 256, size=(40, 30, 3), dtype=np.uint8) for s in range(2)]
    p, jp = proc.process_images(pages), jax_proc.process_images(pages)
    np.testing.assert_array_equal(p["input_ids"], jp["input_ids"])
    for got_batch, want_batch, atol in ((q, jq, 1e-5), (p, jp, 2e-5)):
        with torch.no_grad():
            got = model(**{k: torch.from_numpy(np.asarray(v)) for k, v in got_batch.items()}).numpy()
        want = np.asarray(jax.jit(jax_model.apply)(variables, **{k: jnp.asarray(v) for k, v in want_batch.items()}))
        np.testing.assert_allclose(got, want, atol=atol)


def test_load_retriever_refuses_what_is_not_ported(ckpt, tmp_path):
    # stored-int8 weights are ported: at the default min_dim nothing of this 32-wide checkpoint quantizes
    quantized, _ = load_retriever(ckpt, quantize=True, dtype=torch.float32, device="cpu")
    plain, _ = load_retriever(ckpt, dtype=torch.float32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(quantized.state_dict().values(), plain.state_dict().values()))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):  # colqwen_omni waits; colqwen3_5 is ported
        load_retriever(ckpt, family="colqwen_omni", device="cpu")
    assert {"colpali", "colqwen2", "colqwen2_5", "colqwen3", "colqwen3_5", "colidefics3", "colgemma3",
            "colmodernvbert"} <= set(_PORTED)
    for cfg in ({"model_type": "paligemma"}, {"model_type": "qwen2_vl"}, {"architectures": ["ColQwen2_5Omni"]},
                {"architectures": ["ColSmol"]}, {"model_type": "gemma3"}):
        assert detect_family(cfg) == jax_detect_family(cfg)
    with pytest.raises(ValueError, match="cannot detect"):
        detect_family({"model_type": "bert"})


def test_save_pretrained_exports_by_the_family_registry(tmp_path):
    from colpali_tpu_torch.models.configs import PaliGemmaConfig as TorchPaliGemmaConfig
    from colpali_tpu_torch.models.qwen2_5_vl import Qwen25VLConfig
    from colpali_tpu_torch.models.qwen2_vl import Qwen2VLConfig

    for config, name in ((TorchPaliGemmaConfig(), "colpali"), (PaliGemmaConfig(), "colpali"),
                         (Qwen2VLConfig(), "colqwen2"), (Qwen25VLConfig(), "colqwen25")):
        assert exporter_for(config) == f"export_{name}_state_dict"
    with pytest.raises(ValueError, match="no ported family has the model config dict"):
        save_pretrained(str(tmp_path), {}, config={"model_type": "bert"})


def test_serve_checkpoint_needs_no_quantize_and_answers_search_text(ckpt, tmp_path, capsys):
    rng = np.random.default_rng(1)
    docs = rng.normal(size=(5, 6, 128)).astype(np.float32)
    np.savez(tmp_path / "corpus.npz", **{f"emb_{i}": d / np.linalg.norm(d, axis=-1, keepdims=True)
                                         for i, d in enumerate(docs)})
    argv = [str(tmp_path / "corpus.npz"), "--device", "cpu", "--port", "0", "--checkpoint", ckpt]
    answers = {}
    for mode, extra in (("stored-int8", []), ("bf16", ["--no-quantize"])):  # stored int8 is the default
        httpd = serve.make_server(argv + extra)
        assert f"({mode} weights)" in capsys.readouterr().out
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/search_text"
            req = urllib.request.Request(url, data=json.dumps({"queries": QUERIES, "k": 3}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[mode] = out = json.loads(resp.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
        assert np.asarray(out["doc_ids"]).shape == (2, 3) and np.isfinite(out["scores"]).all()
    assert answers["stored-int8"]["doc_ids"] == answers["bf16"]["doc_ids"]  # nothing here is 512 wide
