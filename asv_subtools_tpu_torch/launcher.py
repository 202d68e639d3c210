"""Stage-gated experiment launcher (counterpart: asv_subtools_tpu/launcher.py;
parity: pytorch/launcher/run*.py).

One python entry replaces the reference's launcher + shell pipeline:
  stage 0: build egs (data lists, speaker map, online wave pipeline)
  stage 1: train (epochs of train steps on one device, validation,
           a checkpoint each epoch)
  stage 2: extract embeddings (bucketed batch extractor) -> xvector ark/scp
  stage 3: score a trial list (backend.ScoreSets: transform chain,
           classifier, S-norm/AS-norm, EER and minDCF); the cosine score
           matrices run on the launcher's device, the rest in f64 on the
           host

Driven by a params dict merged over defaults with assign_params_dict -
the reference launcher idiom (runEcapaXvector_online.py:99-445). The
Launcher runs on ``device``: the CUDA card unless ``device="cpu"``; it
raises without a card.

Stage 0 builds the online wave egs or, with ``data.egs_type="offline"``,
the chunk egs of an egs dir (data/egs_offline.py ``prepare_egs_dir``)
over precomputed feature arks, with ``data.ali_scp`` (phone alignments:
the multi-task egs) and ``data.aux_utt2label`` (auxiliary classes: the FD
egs). Stage 1 trains, all through the Trainer, a SpeakerNet, the
``multi_task_xvector`` (MultiTaskNet), the ``fd_xvector`` (FDSpeakerNet,
two optimizers in turn, ``train.fd``) or, with ``train.sam`` or the
optimizer's ``sam`` flag, by the two-pass SAM step; ``find_lr`` sweeps
the learning rate on the same egs.

``data.feat_type`` picks the host features: fbank, mfcc, fbank_pitch or
mfcc_pitch (the *_pitch types append the 3-dim Kaldi pitch); with
``data.num_bins`` the mfcc types take ``MfccOptions(mel_opts=...)`` (13
cepstra). The wave-input path computes fbank only.

``data.feat_backend`` picks the host front end: "numpy" (the port's
torch features), "native" (the C++ front end, features/native.py) or
"auto" (native per utterance where it can).

Over several devices (one process each, parallel/mesh.py): a ``mesh`` is
taken as given, or built over the initialised process group when
``train.num_model`` > 1, ``train.fsdp`` is set or the group has more than
one process (as JAX's Launcher always builds one over its devices).
``train.fsdp`` takes ZeRO-3 rules (``make_fsdp_rules``, the classifier on
``"model"`` when its size is above 1), ``num_model`` > 1 alone the
row-sharded classifier; every rank builds the same global batches from
the seed and keeps its rows; rank 0 writes the checkpoints, gathered
whole in the one-device format. Stages 2 and 3 run on rank 0 (JAX's
extraction does not use the mesh); the other ranks wait at a barrier.

Two choices differ from the JAX Launcher: the held-out validation egs
keep their last, partial batch (the JAX egs drop it, so a hold-out
smaller than a batch validates on nothing), and ``train(resume_from=...)``
continues the epoch count from the checkpoint's sidecar rather than
restarting it at 1 (which would write over the earlier checkpoints).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

import torch

from .data import Prefetcher, WavEgs, WavEgsXvector, build_spk2int
from .device import resolve_device
from .extract import ExtractConfig, Extractor
from .features.config import FbankOptions, MelOptions, MfccOptions
from .models import MODELS, SpeakerNet
from .nn.loss import LambdaMAnneal, MarginWarm
from .train import (ReduceOnPlateau, Reporter, Trainer, TrainStepConfig, get_lr_schedule, get_optimizer,
                    load_checkpoint, load_transfer, save_checkpoint)
from .train.checkpoint import read_checkpoint_info
from .utils import assign_params_dict, init_logger, set_all_seed
from .weights import init_weights_

DEFAULT_PARAMS: Dict[str, Any] = {
    "seed": 1024,
    "exp_dir": "exp/test",
    # data
    "data": {
        "train_wav_scp": "",
        "train_utt2spk": "",
        "eval_wav_scp": "",
        "chunk_seconds": 2.015,
        "batch_size": 64,
        "speed_perturb": False,
        "shuffle_buffer": 1000,
        "compute_feat": True,
        # fbank | mfcc | fbank_pitch | mfcc_pitch (host features; the
        # wave-input path computes fbank only)
        "feat_type": "fbank",
        # host feature backend: "numpy" (the port's torch CPU features,
        # which match the JAX package's numpy path), "native" (the C++
        # front end, features/native.py; raises on an option its C API
        # cannot express) or "auto" (native where it can, per utterance)
        "feat_backend": "numpy",
        "spec_aug": False,
        "valid_utts": 0,  # hold out N utts for validation (plateau/reporting)
        # mel bins for BOTH training egs and extraction (None = library
        # default 23; the reference's voxceleb recipes use 80/81-fbank);
        # the mfcc types keep 13 cepstra
        "num_bins": None,
        # host pipeline threads for the per-sample stages (decode/aug/feats)
        # - ordered fan-out, so results are identical to workers=1
        "workers": 8,
        # waveform augmentation chain (reference speech_aug yaml):
        # {"mode": "random", "clean_prob": 0.25, "stages": [
        #   {"type": "add_noise", "csv": ...}, {"type": "add_reverb", ...}]}
        "speech_aug": None,
        # >1 = persistent pool of spawn PROCESSES (MultiprocessLoader)
        "num_workers": 1,
        # "offline" = the chunk egs of egs_dir (data.egs_offline.prepare_egs_dir:
        # train.egs.csv / valid.egs.csv / info); aug/aug_params pick the
        # per-chunk SpecAugment or Cutout, ali_scp and aux_utt2label the
        # multi-task and FD labels
        "egs_type": "online",
        "egs_dir": "",
    },
    # model
    "model": {"name": "ecapa_tdnn", "params": {}},
    "loss": {"name": "margin_softmax", "params": {"method": "aam", "m": 0.2}},
    # training
    "train": {
        "epochs": 6,
        "optimizer": {"name": "adamW", "learning_rate": 1e-3, "weight_decay": 1e-4},
        "lr_schedule": {"name": "warmR", "base_lr": 1e-3, "t_0": 10000},
        "max_change": 10.0,
        "accum_grad": 1,
        "compute_dtype": "bfloat16",
        "use_semi_orth": False,
        "report_interval": 100,
        "margin_warm": None,  # {"start_epoch", "end_epoch", "offset_margin", "init_lambda"}
        # transformer model-level warmup (reference trainer_online.py:227:
        # warmup = cur_step / warmup_steps fed to the encoder's
        # layer-bypass alpha); 0 = off
        "model_warmup_steps": 0,
        # the mesh's model-axis size (> 1 holds the margin head's classifier
        # rows over "model": parallel.mesh.classifier_partition_rules)
        "num_model": 1,
        # ZeRO-3: large masters and their moments sharded over "data"
        # (parallel.mesh.make_fsdp_rules)
        "fsdp": False,
    },
    # extraction: mode "feature" (host fbank) or "wave" (the fused fbank kernel)
    "extract": {
        "buckets": [200, 400, 800, 1600, 3200, 6400, 10000],
        "batch": 32,
        # feature mode: {bucket: batch size} (ExtractConfig.batch_sizes)
        "batch_sizes": None,
        "mode": "feature",
        "workers": 8,
    },
}


def _sam_config(t: Dict[str, Any], opt: Dict[str, Any]) -> Optional[tuple]:
    """(rho, adaptive) of the SAM step, from ``train.sam`` ({rho,
    adaptive}) or the optimizer's ``sam`` flag (``sam_rho``,
    ``sam_adaptive``, popped from ``opt``), or None without either. The
    flag names the same step: JAX's factory wraps the optimizer in
    optax.contrib.sam, whose update needs a gradient function that no
    train step hands it (and under optax 0.2.6 the wrapper raises)."""
    flag, rho, adaptive = opt.pop("sam", False), opt.pop("sam_rho", 0.05), opt.pop("sam_adaptive", False)
    if t.get("sam"):
        cfg = t["sam"] if isinstance(t["sam"], dict) else {}
        return float(cfg.get("rho", 0.05)), bool(cfg.get("adaptive", False))
    return (float(rho), bool(adaptive)) if flag else None


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()


class Launcher:
    def __init__(self, params: Optional[Dict] = None, mesh=None, device: Any = None):
        params = params or {}
        self.params = assign_params_dict(DEFAULT_PARAMS, params, support_unknown=True)
        # factory-selection sub-dicts replace the default wholesale when the
        # user picks a different implementation (merging a warmR default's
        # t_0 into a "constant" schedule would be wrong)
        for section, key in [("train", "optimizer"), ("train", "lr_schedule")]:
            user = params.get(section, {}).get(key)
            if user and user.get("name") != DEFAULT_PARAMS[section][key]["name"]:
                self.params[section][key] = dict(user)
        for section in ("model", "loss"):
            user = params.get(section, {})
            if user.get("name") and user["name"] != DEFAULT_PARAMS[section]["name"]:
                self.params[section] = {
                    "name": user["name"],
                    "params": dict(user.get("params", {})),
                }
        self.device = resolve_device(device)
        self.logger = init_logger()
        set_all_seed(self.params["seed"])
        num_model = int(self.params["train"].get("num_model", 1))
        if mesh is None and (num_model > 1 or self.params["train"].get("fsdp") or _world() > 1):
            from .parallel import make_mesh

            mesh = make_mesh(num_model=num_model)
        self.mesh = mesh
        self.spk2int: Optional[Dict] = None
        self.net: Optional[SpeakerNet] = None
        self.state = None
        self.valid_egs = None
        self.trainer: Optional[Trainer] = None
        self.epoch_stats: list = []
        self.score_sets = None

    # -- stage 0 ------------------------------------------------------------
    def build_egs(self):
        p = self.params["data"]
        if p.get("feat_type", "fbank") != "fbank" and not p.get("compute_feat", True):
            # wave-input training runs the fused fbank only; a
            # silently-ignored mfcc/pitch selection would train on the
            # wrong features
            raise ValueError(
                f"data.feat_type={p['feat_type']!r} requires host feature "
                "computation (data.compute_feat=True); the wave-input path "
                "computes fbank on the device only")
        feat_type = p.get("feat_type", "fbank")
        self.feat_opts = None
        if p.get("num_bins"):
            mel = MelOptions(num_bins=int(p["num_bins"]))
            self.feat_opts = MfccOptions(mel_opts=mel) if feat_type.startswith("mfcc") else FbankOptions(mel_opts=mel)
        if p.get("egs_type", "online") == "offline":
            return self._build_offline_egs(p)
        opts = self.feat_opts or (MfccOptions() if feat_type.startswith("mfcc") else FbankOptions())
        # the width the net sees: the in-step fbank has no energy column;
        # the *_pitch types append 3 pitch columns
        self.feat_dim = (opts.dim + 3 * feat_type.endswith("_pitch") if p.get("compute_feat", True)
                         else opts.mel_opts.num_bins)
        self.spk2int = build_spk2int(p["train_utt2spk"])
        num_spks = len(self.spk2int)
        if p.get("speed_perturb"):
            num_spks *= 3
        self.num_targets = num_spks
        self.logger.info("egs: %d speakers (incl. sp-aug)", num_spks)

        train_scp, train_u2s = p["train_wav_scp"], p["train_utt2spk"]
        self.valid_egs = None
        n_valid = int(p.get("valid_utts", 0))
        if n_valid > 0:
            # hold out utterances keeping >=2 per speaker in train
            from .datadir import DataDir

            dd = DataDir.read(os.path.dirname(train_scp))
            train_dd, valid_dd = dd.valid_split(num_utts=n_valid, seed=self.params["seed"])
            split_dir = os.path.join(self.params["exp_dir"], "egs_split")
            train_dd.write(os.path.join(split_dir, "train"))
            valid_dd.write(os.path.join(split_dir, "valid"))
            train_scp = os.path.join(split_dir, "train", "wav.scp")
            train_u2s = os.path.join(split_dir, "train", "utt2spk")
            self.valid_egs = WavEgs(
                os.path.join(split_dir, "valid", "wav.scp"),
                os.path.join(split_dir, "valid", "utt2spk"),
                self.spk2int,
                chunk_seconds=p["chunk_seconds"],
                batch_size=p["batch_size"],
                # always features: the eval step applies the net directly
                # (host compute_feats CMVNs identically to the in-step
                # wave path, so wave-trained models validate consistently)
                compute_feat=True,
                feat_opts=self.feat_opts,
                # the same features as training
                feat_type=feat_type,
                shuffle_buffer=1,
                seed=self.params["seed"],
                drop_last=False,
            )
            self.logger.info("valid split: %d utts held out", len(valid_dd))

        from .data.dataset import _build_train_egs

        compute_feat = p.get("compute_feat", True)
        make_train_egs = functools.partial(
            _build_train_egs,
            dict(
                train_scp=train_scp,
                train_u2s=train_u2s,
                spk2int=self.spk2int,
                chunk_seconds=p["chunk_seconds"],
                batch_size=p["batch_size"],
                speed_perturb=p.get("speed_perturb", False),
                speech_aug=p.get("speech_aug"),
                compute_feat=compute_feat,
                # a wave pipeline needs no options: unpickling them in a
                # spawn worker would import the features package (torch)
                feat_opts=self.feat_opts if compute_feat else None,
                feat_type=p.get("feat_type", "fbank"),
                feat_backend=p.get("feat_backend", "numpy"),
                spec_aug=p.get("spec_aug", False),
                shuffle_buffer=p["shuffle_buffer"],
                seed=self.params["seed"],
                workers=p.get("workers", 1),
            ),
        )
        n_proc = int(p.get("num_workers", 1))
        if n_proc > 1:
            from .data import MultiprocessLoader

            # spawn-safe: partial(module-level fn, primitives dict)
            return MultiprocessLoader(make_train_egs, num_workers=n_proc)
        return make_train_egs()

    def _build_offline_egs(self, p: Dict[str, Any]):
        """The chunk egs of ``data.egs_dir`` (JAX launcher.py:254-319; the
        reference's runSnowdarXvector.py family: get_chunk_egs.py egs dir
        -> BaseBunch.get_bunch_from_egsdir). The validation egs are the
        egs dir's valid.egs.csv, every chunk once (the last batch kept)."""
        from .data.egs_offline import (ChunkEgs, ChunkEgsMultiTask, build_chunk_egs_from_dir, get_info_from_egsdir,
                                       read_ali_scp, read_chunk_csv)

        feat_dim, num_targets, train_csv, valid_csv = get_info_from_egsdir(p["egs_dir"], p.get("train_csv_name"),
                                                                           p.get("valid_csv_name"))
        self.num_targets, self.feat_dim = num_targets, feat_dim
        self.logger.info("offline egs: %d targets, feat_dim %d (%s)", num_targets, feat_dim, p["egs_dir"])
        self.valid_egs = None
        if valid_csv:
            kw = dict(batch_size=p["batch_size"], drop_last=False, seed=self.params["seed"])
            chunks = read_chunk_csv(valid_csv)
            self.valid_egs = (ChunkEgsMultiTask(chunks, read_ali_scp(p["ali_scp"]), **kw) if p.get("ali_scp")
                              else ChunkEgs(chunks, **kw))
        make_egs = functools.partial(build_chunk_egs_from_dir, dict(
            train_csv=train_csv, batch_size=p["batch_size"], aug=p.get("aug"), aug_params=p.get("aug_params"),
            ali_scp=p.get("ali_scp"), aux_utt2label=p.get("aux_utt2label"), seed=self.params["seed"]))
        n_proc = int(p.get("num_workers", 1))
        if n_proc > 1:
            from .data import MultiprocessLoader

            return MultiprocessLoader(make_egs, num_workers=n_proc)
        return make_egs()

    def build_model(self) -> torch.nn.Module:
        """The net of ``model`` and ``loss`` on the launcher's device, its
        weights drawn from ``seed``: a SpeakerNet, or for
        ``multi_task_xvector`` a MultiTaskNet (``model.params`` also holds
        ``num_phones`` and ``mt_alpha``) and for ``fd_xvector`` an
        FDSpeakerNet (``num_aux_targets``). The backbone's ``input_dim`` is
        the width of the features the egs give."""
        m, l = self.params["model"], self.params["loss"]
        mparams = dict(m.get("params", {}))
        mparams.setdefault("input_dim", self.feat_dim)
        head = dict(num_targets=self.num_targets, loss_name=l["name"], loss_params=l.get("params", {}))
        if m["name"] == "multi_task_xvector":
            from .models import MultiTaskNet

            num_phones, mt_alpha = mparams.pop("num_phones"), mparams.pop("mt_alpha", 0.1)
            self.net = MultiTaskNet(MODELS[m["name"]](**mparams, device=self.device), num_phones=num_phones,
                                    mt_alpha=mt_alpha, **head)
        elif m["name"] == "fd_xvector":
            from .train.fd import FDSpeakerNet

            num_aux = mparams.pop("num_aux_targets", 9)
            self.net = FDSpeakerNet(MODELS[m["name"]](**mparams, device=self.device), num_aux_targets=num_aux,
                                    **head)
        else:
            self.net = SpeakerNet(backbone=MODELS[m["name"]](**mparams, device=self.device), **head)
        init_weights_(self.net, self.params["seed"])
        return self.net

    # -- stage 1 ------------------------------------------------------------
    def train(self, egs, resume_from: Optional[str] = None):
        """Epochs of the train step through the Trainer. ``train.sam``
        ({rho, adaptive}) or the optimizer's ``sam`` flag (``sam_rho``,
        ``sam_adaptive``) takes the two-pass SAM step (feature input
        only); an FDSpeakerNet takes the FD step, two optimizers in turn
        (``train.fd``: aux_weight, adv_weight, cycle, adv_steps and
        adv_optimizer {name, learning_rate, ...}, sgd 1e-2 by default;
        JAX launcher.py:523-591), and validates nothing, as in JAX."""
        t = self.params["train"]
        from .train.fd import FDSpeakerNet

        fd = isinstance(self.net, FDSpeakerNet)
        opt = dict(t["optimizer"])
        sam = _sam_config(t, opt)
        if sam and not self.params["data"].get("compute_feat", True):
            raise ValueError("SAM requires feature-input egs (data.compute_feat=True or offline egs)")
        sched_cfg = dict(t["lr_schedule"])
        sched_name = sched_cfg.pop("name")
        plateau = None
        if sched_name == "reduceP":
            # reduceP = constant base lr + host-side ReduceOnPlateau driven
            # by the valid loss (reference lr_scheduler_online.py:89-117);
            # the scale enters the step as its lr_scale input
            plateau = ReduceOnPlateau(**{k: v for k, v in sched_cfg.items() if k != "base_lr"})
            schedule = get_lr_schedule("constant", base_lr=sched_cfg.get("base_lr", 1e-3))
        else:
            schedule = get_lr_schedule(sched_name, **sched_cfg)
        opt["learning_rate"] = schedule
        tx = get_optimizer(opt.pop("name"), **opt)
        margin_warm = None
        if t.get("margin_warm"):
            margin_warm = MarginWarm(**t["margin_warm"])
        elif t.get("lambda_m_anneal"):
            # the reference's step_params["m"] lambda annealing
            margin_warm = LambdaMAnneal(**t["lambda_m_anneal"])
        wave = not self.params["data"].get("compute_feat", True)
        config = TrainStepConfig(
            max_change=t["max_change"],
            accum_grad=t["accum_grad"],
            compute_dtype=torch.bfloat16 if t["compute_dtype"] == "bfloat16" else torch.float32,
            use_semi_orth=t.get("use_semi_orth", False),
            # data.compute_feat=False -> wave-input training: the host only
            # decodes/augments waveforms; the fused fbank kernel, CMVN and
            # SpecAugment run inside the step
            wave_input=wave,
            fbank_opts=self.feat_opts,
            spec_aug=wave and self.params["data"].get("spec_aug", False),
            model_warmup_steps=int(t.get("model_warmup_steps", 0) or 0),
        )
        partition_rules = None
        if self.mesh is not None and not fd:
            # the FD step runs replicated, as JAX's (launcher.py:523-590)
            from .parallel import classifier_partition_rules, make_fsdp_rules

            model_n = int(self.mesh.size(1))
            if t.get("fsdp"):
                partition_rules = make_fsdp_rules(self.mesh)
            elif model_n > 1:
                partition_rules = classifier_partition_rules
        placement = None
        if self.mesh is not None:
            from .train.trainer import make_placement

            placement = make_placement(self.net, self.mesh, partition_rules, tx)
        step_fn = None
        if fd:
            from .train.fd import init_fd_state, make_fd_train_step

            f = t.get("fd") or {}
            adv_cfg = dict(f.get("adv_optimizer", {"name": "sgd", "learning_rate": 1e-2}))
            tx_adv = get_optimizer(adv_cfg.pop("name"), **adv_cfg)
            step_fn = make_fd_train_step(
                self.net, tx, tx_adv, aux_weight=float(f.get("aux_weight", 0.1)),
                adv_weight=float(f.get("adv_weight", 0.1)), cycle=int(f.get("cycle", 70)),
                adv_steps=int(f.get("adv_steps", 20)), config=config, placement=placement)
        elif sam:
            # the two-pass SAM step (the reference's runSnowdarXvectorSAM
            # family, trainer_online_sam.py)
            from .train.sam import make_sam_train_step

            step_fn = make_sam_train_step(self.net, tx, rho=sam[0], adaptive=sam[1], config=config,
                                          placement=placement)
        # one reporter: rank 0's
        reporter = Reporter(log_dir=os.path.join(self.params["exp_dir"], "log")) if _rank() == 0 else None
        trainer = Trainer(self.net, tx, lr_schedule=schedule, config=config, margin_warm=margin_warm,
                          plateau=plateau, report_interval=t["report_interval"], reporter=reporter,
                          device=self.device, step_fn=step_fn, mesh=self.mesh, partition_rules=partition_rules)
        self.trainer = trainer
        # FD's opt_state is the pair (main, adversary)
        state = init_fd_state(self.net, tx, tx_adv, self.device) if fd else trainer.init_state()
        start_epoch = 0
        if resume_from:
            state = trainer.shard_state(load_checkpoint(resume_from, trainer.full_state(state)))
            epoch = read_checkpoint_info(resume_from).get("epoch")
            start_epoch = epoch if isinstance(epoch, int) else 0
            self.logger.info("resumed from %s at step %d, epoch %d", resume_from, int(state.step), start_epoch)
        else:
            # transfer-learning init (the reference's LM-finetune idiom,
            # framework.py:133-143): train.transfer = {"from": ckpt,
            # "exclude": ["loss"], ...} copies matching top-level subtrees
            # from a previous phase's checkpoint
            tr = t.get("transfer") or self.params.get("transfer")
            if tr and tr.get("from"):
                full = trainer.full_state(state)
                full.params = load_transfer(full.params, tr["from"], include=tr.get("include"),
                                            exclude=tr.get("exclude"), rename=tr.get("rename"))
                state = trainer.shard_state(full)
                self.logger.info("transfer init from %s (exclude=%s)", tr["from"], tr.get("exclude"))
        if isinstance(margin_warm, MarginWarm) and margin_warm.epoch_iter is None:
            # no epoch_iter given: 1000 steps an epoch, as the JAX Launcher
            # assumes (launcher.py:502-504; there LambdaMAnneal, which has no
            # epoch_iter, fails on this line)
            margin_warm.update_step_range(1000, overwrite=True)
        generator = torch.Generator(device=self.device).manual_seed(self.params["seed"])
        ckpt_dir = os.path.join(self.params["exp_dir"], "checkpoints")
        pin = self.device.type == "cuda"
        for epoch in range(start_epoch, t["epochs"]):
            egs.set_epoch(epoch)
            state, metrics = trainer.run_epoch(state, Prefetcher(egs, pin_memory=pin), generator, epoch=epoch)
            stats = dict(trainer.epoch_stats, epoch=epoch + 1)
            if self.valid_egs is not None and not fd:
                vmetrics = trainer.validate(state, iter(self.valid_egs))
                metrics = {**metrics, **{f"valid_{k}": v for k, v in vmetrics.items()}}
                if trainer.plateau is not None:
                    trainer.plateau.update(vmetrics["loss"])
            full = trainer.full_state(state)
            if _rank() == 0:
                save_checkpoint(ckpt_dir, full, epoch + 1, info=metrics)
            _barrier(self.mesh)
            self.epoch_stats.append(dict(stats, metrics=metrics))
            self.logger.info("epoch %d: %s", epoch + 1, metrics)
        if reporter is not None:
            reporter.close()
        if hasattr(egs, "close"):  # stop a MultiprocessLoader pool
            egs.close()
        # the whole state on every rank: extraction and scoring read it
        self.state = trainer.full_state(state)
        return self.state

    def find_lr(self, egs, start_lr: float = 1e-8, end_lr: float = 1.0, num_steps: int = 100) -> Dict[str, Any]:
        """The LR range finder on this configuration's net, optimizer and
        egs (JAX launcher.py:593-646; the reference launchers'
        run_lr_finder flag, lr_finder.py:24-219): the train step with the
        optimizer's base LR 1.0 and ``lr_scale`` the swept LR, from the
        net's seeded weights; on wave egs the fused fbank kernel runs in
        the step. The host reads each step's loss: one wait a step.
        Returns {"lrs", "losses", "suggested_lr"}."""
        from .data.dataset import _pin_batch
        from .train import init_train_state, make_train_step, run_lr_finder
        from .train.trainer import batch_to_device

        t = self.params["train"]
        opt = dict(t["optimizer"])
        opt.pop("learning_rate", None)
        _sam_config(t, opt)  # the finder runs the plain step
        tx = get_optimizer(opt.pop("name"), learning_rate=1.0, **opt)
        cfg = TrainStepConfig(max_change=t["max_change"],
                              compute_dtype=torch.bfloat16 if t["compute_dtype"] == "bfloat16" else torch.float32,
                              wave_input=not self.params["data"].get("compute_feat", True),
                              fbank_opts=self.feat_opts)
        step = make_train_step(self.net, tx, config=cfg)
        # pinned: the copy to the card is queued, so the loss read is the only wait
        pin = _pin_batch if self.device.type == "cuda" else (lambda b: b)

        def step_fn(state, batch, generator, lr):
            batch = batch_to_device(pin(batch), self.device, keys=("x", "y", "mask"))
            return step(state, batch, generator, 1.0, 0.0, lr)

        state = init_train_state(self.net, tx, self.device)
        generator = torch.Generator(device=self.device).manual_seed(self.params["seed"])
        out = run_lr_finder(step_fn, state, iter(egs), generator, start_lr=start_lr, end_lr=end_lr,
                            num_steps=num_steps)
        self.logger.info("lr finder: suggested_lr=%s", out["suggested_lr"])
        return out

    # -- stage 2 ------------------------------------------------------------
    def extract(self, wav_scp: str, out_prefix: str, state=None) -> Dict:
        """Embeddings of every utterance of ``wav_scp`` from the backbone of
        ``state`` (the trained state by default), written to
        ``out_prefix``.ark/.scp; returns the extractor's stats. On a mesh,
        rank 0 extracts and the others wait for it (their stats are {})."""
        if _rank() != 0:
            _barrier(self.mesh)
            return {}
        stats = self._extract(wav_scp, out_prefix, state)
        _barrier(self.mesh)
        return stats

    def _extract(self, wav_scp: str, out_prefix: str, state=None) -> Dict:
        state = state if state is not None else self.state
        e = self.params["extract"]
        backbone = self.net.backbone
        tensors = {k[len("backbone."):]: v for k, v in {**state.params, **state.batch_stats}.items()
                   if k.startswith("backbone.")}

        def model_apply(x, mask):
            backbone.eval()
            out = torch.func.functional_call(backbone, tensors, (x, mask))
            # the multi-task and FD x-vectors return a pair; extraction takes
            # the (speaker) embedding (JAX launcher.py:659-663)
            return out[0] if isinstance(out, tuple) else out

        if e.get("mode", "feature") == "wave":
            if self.params["data"].get("feat_type", "fbank") != "fbank":
                raise ValueError(
                    "extract.mode='wave' computes fbank on the device only; use "
                    "mode='feature' for "
                    f"feat_type={self.params['data']['feat_type']!r}")
            # the fused fbank kernel: the host only decodes wav
            from .data import ParallelMapper
            from .extract import WAVE_BUCKETS, make_wave_embed_fn
            from .io import read_wav

            embed_fn = make_wave_embed_fn(model_apply, fbank_opts=getattr(self, "feat_opts", None))
            ex = Extractor(embed_fn, ExtractConfig(buckets=WAVE_BUCKETS, default_batch=e["batch"],
                                                   max_chunk=WAVE_BUCKETS[-1]), device=self.device)
            entries = []
            with open(wav_scp) as f:
                for line in f:
                    parts = line.split(None, 1)
                    if len(parts) == 2:
                        entries.append((parts[0], parts[1].strip()))

            def decode(kv):
                k, path = kv
                wav, _sr = read_wav(path)
                return k, (wav[0] if wav.ndim > 1 else wav)

            items = ParallelMapper(decode, entries, workers=e.get("workers", 8))
        else:
            ex = Extractor(model_apply, ExtractConfig(buckets=tuple(e["buckets"]), default_batch=e["batch"],
                                                      batch_sizes=e.get("batch_sizes")), device=self.device)
            items = iter(WavEgsXvector(
                wav_scp, feat_opts=getattr(self, "feat_opts", None),
                feat_type=self.params["data"].get("feat_type", "fbank"),
                feat_backend=self.params["data"].get("feat_backend", "numpy"),
                workers=e.get("workers", 1),
            ))
        stats = ex.extract_to_ark(iter(items), out_prefix + ".ark", out_prefix + ".scp")
        self.logger.info("extraction: %s", stats)
        return stats

    # -- stage 3 ------------------------------------------------------------
    def score(
        self,
        train_scp: str,
        train_utt2spk: str,
        enroll_scp: str,
        test_scp: str,
        trials_path: str,
        *,
        process: str = "submean-norm",
        classifier: str = "cosine",
        score_norm: Optional[str] = None,
        top_n: int = 300,
        cohort_size: int = 3000,
    ) -> Dict[str, float]:
        """scoreSets stage: transform chain + classifier + metrics. The
        train vectors with a speaker in ``train_utt2spk`` fit the chain
        (speaker ids are the speakers' sorted indices); the cohort is the
        first ``cohort_size`` of them in sorted key order. The
        ``ScoreSets`` of the last call stays in ``self.score_sets``. On a
        mesh, rank 0 scores and the others wait for it (their result is
        {})."""
        if _rank() != 0:
            _barrier(self.mesh)
            return {}
        out = self._score(train_scp, train_utt2spk, enroll_scp, test_scp, trials_path, process=process,
                          classifier=classifier, score_norm=score_norm, top_n=top_n, cohort_size=cohort_size)
        _barrier(self.mesh)
        return out

    def _score(self, train_scp, train_utt2spk, enroll_scp, test_scp, trials_path, *, process, classifier,
               score_norm, top_n, cohort_size) -> Dict[str, float]:
        import numpy as np

        from .backend import ScoreConfig, ScoreSets, Trials
        from .io import read_vec_flt_scp

        train = dict(read_vec_flt_scp(train_scp))
        with open(train_utt2spk) as f:
            u2s = dict(line.split()[:2] for line in f if line.strip())
        keys = sorted(k for k in train if k in u2s)
        spks = sorted(set(u2s[k] for k in keys))
        s2i = {s: i for i, s in enumerate(spks)}
        x = np.stack([train[k] for k in keys])
        ids = np.asarray([s2i[u2s[k]] for k in keys])
        cfg = ScoreConfig(process=process, classifier=classifier, score_norm=score_norm, top_n=top_n)
        pipe = ScoreSets(cfg, device=self.device).fit(x, ids)
        self.score_sets = pipe
        enroll = dict(read_vec_flt_scp(enroll_scp))
        test = dict(read_vec_flt_scp(test_scp))
        cohort = x[:cohort_size] if score_norm else None
        out = pipe.run(enroll, test, Trials.read(trials_path), cohort=cohort)
        self.logger.info("scoring: %s", out)
        return out

    def gather_results_from_epochs(
        self,
        epochs,
        train_scp_fmt: str,
        train_utt2spk: str,
        enroll_scp_fmt: str,
        test_scp_fmt: str,
        trials_path: str,
        **score_kwargs,
    ) -> Dict[Any, Dict[str, float]]:
        """Score a range of epoch checkpoints and collect metrics per epoch
        (parity: gather_results_from_epochs.sh, which loops scoreSets.sh
        over exp/<model>/far_epoch_N vector dirs).

        The *_fmt paths may contain "{epoch}", substituted per epoch; plain
        paths reuse one extraction for all epochs (when only the back-end
        config varies). Returns {epoch: metrics dict} and logs a summary.
        """
        results = {}
        for epoch in epochs:
            train_scp, enroll_scp, test_scp = (p.format(epoch=epoch)
                                               for p in (train_scp_fmt, enroll_scp_fmt, test_scp_fmt))
            results[epoch] = self.score(train_scp, train_utt2spk, enroll_scp, test_scp, trials_path, **score_kwargs)
        for epoch, m in sorted(results.items()):
            self.logger.info("epoch %s: %s", epoch, m)
        return results
