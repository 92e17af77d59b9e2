"""Training orchestrator: ``ColModelTraining`` (counterpart of
:mod:`colpali_tpu.training.orchestrator`, single device).

It owns the collator, the sampler, the train state and the step loop: a
log line every ``log_steps``, periodic checkpoints with resume, an eval hook
and the final export. The inner loop is the train step of
:mod:`colpali_tpu_torch.training.trainer`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from colpali_tpu_torch.data.collator import VisualRetrieverCollator
from colpali_tpu_torch.data.prefetch import prefetch
from colpali_tpu_torch.data.sampler import SingleDatasetBatchSampler
from colpali_tpu_torch.evaluation.evaluator import evaluate_retrieval_from_index
from colpali_tpu_torch.ops.quant_dense import dequantize_state_dict, quantize_params
from colpali_tpu_torch.retrieval.store import DeviceIndexBuilder
from colpali_tpu_torch.training.checkpointing import CheckpointManager, save_pretrained
from colpali_tpu_torch.training.lora import LoraAdapters
from colpali_tpu_torch.training.trainer import TrainConfig, TrainState, make_eval_step, make_train_step, to_device
from colpali_tpu_torch.utils.reporting import MetricsLogger


@dataclasses.dataclass
class ColModelTrainingConfig:
    """What a training run is made of.

    ``model`` is a built ``nn.Module`` (``ColPali(..., remat=True)`` for the
    full recipe); ``params``, when given, is a state dict loaded into it.
    ``device`` is where the run happens: the card unless the caller asks
    for ``"cpu"``. ``peft`` takes a :class:`LoraSpec`: the base stays
    frozen, only the rank-r adapters train, and :meth:`ColModelTraining.save`
    exports the merged weights.

    ``quantize_frozen_base`` (LoRA runs only) stores the frozen vision
    tower's projections as int8 before the adapters are attached:
    ``quantize_params(model, min_dim=quant_min_dim, path_filter=<"visual" or
    "vision" in the path>)``, so the tower runs on kernels Q1a/Q1b and records
    no gradient, and :meth:`ColModelTraining.save` exports its ``q * scale``,
    the values training computed with. It changes the training numerics.

    Not ported yet, and refused: ``mesh`` (multi-GPU). ``remat_policy``
    accepts ``None`` or ``"full"`` only: ``torch.utils.checkpoint`` saves
    nothing inside a layer, and has no counterpart of the JAX package's
    named policies such as ``"dots"``; whether layers are checkpointed at
    all is the model's ``remat`` flag.
    """

    model: Any
    loss_func: Any
    train_datasets: list
    params: Optional[Dict[str, Any]] = None
    processor: Any = None
    eval_dataset: Optional[Any] = None
    output_dir: str = "./models/run"
    global_batch_size: int = 8
    num_epochs: int = 1
    max_steps: Optional[int] = None
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: Optional[Any] = None
    save_steps: int = 500
    save_total_limit: int = 1
    log_steps: int = 10
    eval_steps: Optional[int] = None  # None -> eval at each epoch end only
    eval_batch_size: Optional[int] = None  # defaults to global_batch_size
    report_to: Any = "jsonl"  # "jsonl" | "wandb" | ["jsonl", "wandb"] | "none"
    resume_from_checkpoint: bool = False
    peft: Optional[Any] = None
    seed: int = 0
    pad_seq_to: Optional[Any] = None  # int or bucket list (see data.collator)
    pad_patches_to: Optional[Any] = None
    remat_policy: Optional[str] = None
    quantize_frozen_base: bool = False
    quant_min_dim: int = 512  # projections with a dim below this stay in the model's dtype
    device: Any = "cuda"


class ColModelTraining:
    """Owns collator, sampler, train state and the step loop."""

    def __init__(self, config: ColModelTrainingConfig):
        if config.mesh is not None:
            raise NotImplementedError("ColModelTrainingConfig(mesh=...): multi-GPU training is not ported yet")
        if config.quantize_frozen_base and config.peft is None:
            raise ValueError("quantize_frozen_base stores the frozen vision tower as int8 under LoRA: pass peft=")
        if config.remat_policy not in (None, "full"):
            raise NotImplementedError(
                f"remat_policy={config.remat_policy!r}: torch.utils.checkpoint has no named policies; "
                "pass None or 'full' and build the model with remat=True")
        self.config = config
        self.device = torch.device(config.device)
        self.collator = VisualRetrieverCollator(
            config.processor, pad_seq_to=config.pad_seq_to, pad_patches_to=config.pad_patches_to)
        self.sampler = SingleDatasetBatchSampler(config.train_datasets, config.global_batch_size, seed=config.seed)
        self._all_data = _ConcatDataset(config.train_datasets)
        self.logger = MetricsLogger(config.output_dir, report_to=config.report_to)

        has_negatives = self._probe_negatives()
        self.model = config.model.to(self.device)
        if config.params is not None:
            self.model.load_state_dict(config.params)

        adapters = None
        self.quantized_paths: list = []
        if config.peft is not None:
            if config.quantize_frozen_base:  # only the vision tower, which the adapters never target
                self.quantized_paths = quantize_params(self.model, min_dim=config.quant_min_dim,
                                                       path_filter=lambda p: "visual" in p or "vision" in p)
            # the base is frozen: optimizer state exists for the adapters only
            adapters = LoraAdapters(self.model, config.peft, seed=config.seed + 1)
        self.state = TrainState(self.model, config.train, adapters)
        self.train_step = make_train_step(config.loss_func, has_negatives=has_negatives, peft=config.peft,
                                          seed=config.seed)
        self.eval_step = (make_eval_step(config.loss_func, has_negatives=has_negatives)
                          if config.eval_dataset is not None else None)

        self.ckpt = CheckpointManager(
            f"{config.output_dir}/checkpoints",
            save_interval_steps=config.save_steps,
            max_to_keep=config.save_total_limit,
        )
        if config.resume_from_checkpoint and self.ckpt.latest_step is not None:
            self.state = self.ckpt.restore(self.state)

    def _probe_negatives(self) -> bool:
        sample = self.config.train_datasets[0][0]
        return sample.get("neg_target") is not None

    def close(self) -> None:
        """Take the LoRA hooks off the model, so that it can be used (or
        trained anew) without these adapters."""
        if self.state.adapters is not None:
            self.state.adapters.detach()
        self.logger.close()

    def batches(self, epoch: int, skip: int = 0) -> Iterable[Dict[str, Any]]:
        """The epoch's batch stream; ``skip`` drops batches a resumed run has
        consumed already, before collation (the sampler's schedule is
        deterministic per epoch, so skipping replays the uninterrupted
        order)."""
        self.sampler.set_epoch(epoch)
        for n_batch, indices in enumerate(self.sampler):
            if n_batch < skip:
                continue
            yield self.collator([self._all_data[i] for i in indices])

    @property
    def metrics_history(self) -> list:
        return self.logger.history

    def _eval_setup(self) -> None:
        """Collate the eval set once (it is not sampled) and group its rows
        by gold document: queries that share a corpus doc id credit every
        copy of it in the eval corpus (row j holds example j's positive).
        Datasets without a corpus carry raw images, so each row is its own
        gold; so is a row with several positives, of which the collator
        embeds a random one."""
        cfg = self.config
        ds = cfg.eval_dataset
        bs = cfg.eval_batch_size or cfg.global_batch_size
        self._eval_batches = [
            self.collator([ds[i] for i in range(start, min(start + bs, len(ds)))])
            for start in range(0, len(ds), bs)
        ]
        keys = []
        for i in range(len(ds)):
            key: Any = ("__row__", i)
            if getattr(ds, "corpus", None) is not None:
                t = ds.data[i][ds.pos_target_column_name]
                if isinstance(t, (list, tuple)):
                    t = t[0] if len(t) == 1 else None
                if isinstance(t, (int, str, np.integer)):
                    key = int(t) if isinstance(t, np.integer) else t
            keys.append(key)
        groups: Dict[Any, list] = {}
        for j, key in enumerate(keys):
            groups.setdefault(key, []).append(j)
        self._eval_relevance = [groups[key] for key in keys]

    def evaluate(self) -> Dict[str, float]:
        """Eval pass over ``config.eval_dataset``: the mean loss and the
        retrieval metrics of every eval query against the whole eval corpus.
        Doc embeddings go straight from the eval forward into a bf16 index
        built on the device (:class:`DeviceIndexBuilder`), which is searched
        exactly (kernel K5). Results are cached by train step.

        Multi-vector models only, as in the JAX package: a single-vector
        (Bi) model's ``(B, D)`` query embeddings have no token axis for the
        query mask, where JAX's ``q[i][q_mask[i]]`` raises an IndexError.
        Here the first eval batch's embeddings refuse such a model with a
        ValueError that says so."""
        step_now = self.state.step
        cached = getattr(self, "_eval_cache", None)
        if cached is not None and cached[0] == step_now:
            return cached[1]
        if not hasattr(self, "_eval_batches"):
            self._eval_setup()

        losses, q_embs, doc_outs = [], [], []
        for batch in self._eval_batches:
            loss, q, d = self.eval_step(self.state, to_device(batch, self.device))
            if q.ndim != 3:
                raise ValueError(f"evaluate() ranks multi-vector embeddings (B, tokens, dim); this model returns "
                                 f"{tuple(q.shape)} single vectors, which the JAX package's evaluate() cannot mask "
                                 "either (it indexes a (dim,) vector with the (tokens,) query mask and raises)")
            losses.append(loss)
            q = q.float().cpu().numpy()
            q_mask = np.asarray(batch["query_attention_mask"]).astype(bool)
            q_embs.extend(q[i][q_mask[i]] for i in range(q.shape[0]))
            doc_outs.append((d, batch["doc_attention_mask"]))  # stays on the device

        doc_tokens = max(int(d.shape[1]) for d, _ in doc_outs)
        index_builder = DeviceIndexBuilder(doc_tokens=doc_tokens, dim=int(doc_outs[0][0].shape[-1]), dtype="bf16")
        for d, mask in doc_outs:
            index_builder.add(d, mask=torch.as_tensor(np.asarray(mask), device=d.device))
        self.eval_index = index_builder.build()
        self.eval_queries = q_embs
        ranked = evaluate_retrieval_from_index(self.eval_index, q_embs, relevance=self._eval_relevance,
                                               k_values=(1, 5))
        metrics = {"eval_loss": float(torch.stack(losses).float().mean())}
        metrics.update({f"eval_{k}": v for k, v in ranked.items()})
        self._eval_cache = (step_now, metrics)
        return metrics

    def train(self, on_step: Optional[Callable[[int, Dict], None]] = None) -> Dict[str, Any]:
        cfg = self.config
        step = self.state.step
        t_start = time.time()
        samples = 0
        eval_metrics: Dict[str, float] = {}

        def run_eval() -> None:
            nonlocal eval_metrics
            eval_metrics = self.evaluate()
            self.logger.log({"step": step, **eval_metrics})
            print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in eval_metrics.items()))

        # resume mid-epoch: map the restored step back to (epoch, batch) and
        # skip the consumed batches. Only with resume_from_checkpoint: a
        # second train() call on a finished or warm-started state runs full
        # epochs from the top.
        steps_per_epoch = max(len(self.sampler), 1)
        resuming = cfg.resume_from_checkpoint and step > 0
        start_epoch = min(step // steps_per_epoch, max(cfg.num_epochs - 1, 0)) if resuming else 0
        for epoch in range(start_epoch, cfg.num_epochs):
            resume_skip = max(0, step - epoch * steps_per_epoch) if resuming and epoch == start_epoch else 0
            # collation (tokenizing, image preprocessing) runs ahead on a
            # daemon thread, beside the device step
            for batch in prefetch(self.batches(epoch, skip=resume_skip), buffer_size=2):
                metrics = self.train_step(self.state, to_device(batch, self.device))
                step += 1
                samples += cfg.global_batch_size
                if step % cfg.log_steps == 0:
                    entry = {"step": step, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
                    self.logger.log(entry)
                    if hasattr(cfg.loss_func, "flush_warnings"):  # the loss was just read: the device has been waited for
                        cfg.loss_func.flush_warnings()
                    print(f"step {step}: loss={entry['loss']:.4f} grad_norm={entry['grad_norm']:.3f}")
                self.ckpt.save(step, self.state)
                if on_step is not None:
                    on_step(step, metrics)
                if self.eval_step is not None and cfg.eval_steps and step % cfg.eval_steps == 0:
                    run_eval()
                if cfg.max_steps is not None and step >= cfg.max_steps:
                    break
            else:
                if self.eval_step is not None and not cfg.eval_steps:
                    run_eval()  # eval at the end of each epoch
                continue
            break
        self.ckpt.wait()
        runtime = time.time() - t_start
        summary = {
            "train_runtime": runtime,
            "train_samples_per_second": samples / runtime if runtime > 0 else 0.0,
            "final_step": step,
            **eval_metrics,
        }
        print(f"train_runtime: {runtime:.1f}s, samples/sec: {summary['train_samples_per_second']:.2f}")
        self.logger.close()
        return summary

    def save(self, output_dir: Optional[str] = None) -> None:
        """Final export. With a peft recipe the export is the merged weights
        ``W + (alpha/r) A @ B``: a checkpoint that serves as it is. A
        stored-int8 frozen tower is exported as ``q * scale`` in the model's
        dtype."""
        out = output_dir or self.config.output_dir
        adapters = self.state.adapters
        state_dict = adapters.merged_state_dict(self.model) if adapters is not None else self.model.state_dict()
        if self.quantized_paths:
            dtype = next(p.dtype for p in self.model.parameters() if p.is_floating_point())
            state_dict = dequantize_state_dict(state_dict, dtype)
        save_pretrained(out, state_dict, config=getattr(self.model, "config", None))
        proc = self.config.processor
        if proc is not None and hasattr(proc, "save_pretrained"):
            proc.save_pretrained(out)


class _ConcatDataset:
    """Global-index view over several datasets (the sampler emits cumulative
    indices)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.offsets = np.concatenate([[0], np.cumsum([len(d) for d in datasets])])

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[ds][idx - int(self.offsets[ds])]

    def __len__(self):
        return int(self.offsets[-1])
