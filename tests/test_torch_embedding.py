"""The port's embedding extraction against the JAX package, on the CPU.

* (8) `embed_batch` with each pooling (``last``, ``max``, ``mean``,
  ``none``), CI and NA, against JAX's ``embed_batch`` on converted weights
  (``test_torch_fine_tuning.py``'s batch, with its float64-accumulated
  event times), and the files `get_embeddings` writes against JAX's
  ``get_embeddings`` on the same pretrained CI weights
  (``test_torch_fine_tuning.py``'s directories), each split one row
  a subject. Within ``EMB`` (rtol 1e-5, atol 1e-4): the cause is
  ``test_torch_fine_tuning.py``'s ``LOGITS`` (late events' times of ~2.6e4
  minutes through the sinusoidal time encoding in fp32).
* `get_embeddings` defaults to the card and raises without one; an
  existing file is kept unless ``do_overwrite``.
"""

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.training import embedding as jax_embedding
from eventstreamgpt_tpu.training import fine_tuning as jax_fine_tuning
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.training.embedding import EmbeddingsOnlyModel, embed_batch, get_embeddings
from eventstreamgpt_tpu_torch.training.fine_tuning import FinetuneConfig

from .test_torch_fine_tuning import TASK, jax_config, sample_batch, write_pretrained
from .test_torch_train import to_torch

EMB = dict(rtol=1e-5, atol=1e-4)
SPLITS = ("train", "tuning", "held_out")


@pytest.fixture(scope="module")
def encoders():
    """{mode: (jax config, flax params of JAX's EmbeddingsOnlyModel, jax batch)}."""
    out = {}
    for mode in ("ci", "na"):
        config, batch = jax_config(mode, "binary"), sample_batch("binary")
        params = jax.jit(jax_embedding.EmbeddingsOnlyModel(config).init)(jax.random.PRNGKey(2), batch)
        out[mode] = (config, params, batch)
    return out


@pytest.mark.parametrize("pooling", ["last", "max", "mean", "none"])
@pytest.mark.parametrize("mode", ["ci", "na"])
def test_embed_batch_matches_jax(encoders, mode, pooling):
    config, params, jbatch = encoders[mode]
    want = np.asarray(jax_embedding.embed_batch(jax_embedding.EmbeddingsOnlyModel(config), params, config, jbatch,
                                                pooling))  # fmt: skip
    tcfg = StructuredTransformerConfig.from_dict(config.to_dict())
    model = load_jax_params(EmbeddingsOnlyModel(tcfg), jax.tree_util.tree_map(np.asarray, params))
    got = embed_batch(model, tcfg, to_torch(jbatch), pooling)
    assert not got.requires_grad and got.dtype == torch.float32
    B, L, H = jbatch.event_mask.shape + (tcfg.hidden_size,)
    assert tuple(got.shape) == want.shape == ((B, L, H) if pooling == "none" else (B, H))
    np.testing.assert_allclose(got.numpy(), want, **EMB)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """``(jax embeddings, port embeddings, split lengths, port config)`` of
    both packages' `get_embeddings` on the same pretrained CI weights
    (``last`` pooling; the NA encoder's pooled forward is
    `test_embed_batch_matches_jax`'s)."""
    jax_dir, port_dir = write_pretrained(tmp_path_factory.mktemp("emb"))
    jcfg = jax_fine_tuning.FinetuneConfig(load_from_model_dir=jax_dir, task_df_name=TASK,
                                          optimization_config=JaxOptimizationConfig(validation_batch_size=5))  # fmt: skip
    tcfg = FinetuneConfig(load_from_model_dir=port_dir, task_df_name=TASK, optimization_config={"validation_batch_size": 5})
    jfiles = jax_embedding.get_embeddings(jcfg)
    tfiles = get_embeddings(tcfg, device="cpu")
    lengths = {sp: len(TorchDataset(tcfg.data_config, sp)) for sp in SPLITS}
    return {sp: np.load(f) for sp, f in jfiles.items()}, {sp: np.load(f) for sp, f in tfiles.items()}, lengths, tcfg


@pytest.mark.parametrize("split", SPLITS)
def test_get_embeddings_writes_jax_files(written, split):
    want, got, lengths, cfg = written
    assert got[split].shape == want[split].shape == (lengths[split], cfg.config.hidden_size)
    assert lengths[split] % 5 != 0 or split == "train"  # a short last batch: its fill rows were dropped
    np.testing.assert_allclose(got[split], want[split], **EMB)
    path = cfg.load_from_model_dir / "embeddings" / TASK / f"{split}_embeddings.npy"
    assert path.is_file()


def test_get_embeddings_keeps_an_existing_file_and_defaults_to_the_card(written, monkeypatch, capsys):
    _, got, _, cfg = written
    path = cfg.load_from_model_dir / "embeddings" / TASK / "tuning_embeddings.npy"
    np.save(path, np.zeros(3))
    get_embeddings(cfg, device="cpu")
    assert "already exist" in capsys.readouterr().out and np.load(path).shape == (3,)
    cfg.do_overwrite = True
    get_embeddings(cfg, device="cpu")
    np.testing.assert_array_equal(np.load(path), got["tuning"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_embeddings(cfg)
