"""Where a training cell's gap to the reference comes from: the program's
first three steps in mixed precisions, and the reference rounded to
bfloat16 in chosen places, each against the float32 reference on the
same seeded weights and batches, layer by layer.

    python3 benchmark/witness.py --workload resnet34.train_vox2 --seeds 1,2,3 \\
        [--variants program,k1_f32,...] \\
        [--mix '{"amplitude": 1000}'] [--ops]

Variants (the front end K1 and CMVN, then the trunk and head):
- ``program``: the program as the cell runs it (K1 and trunk in the
  configuration's type); ``program_f32``: both in float32, TF32 off;
- ``k1_f32``: K1 in float32, the trunk in the configuration's type;
  ``trunk_f32``: K1 in the configuration's type, the trunk in float32;
- ``ref_bf16``: the reference with every tensor the program holds in
  bfloat16 rounded to it, on the way forward and back;
  ``ref_bf16_fwd``: rounded on the way forward only;
  ``ref_bf16_feats``: only the features rounded;
- ``ref_fp8``: the reference as the lower-precision control computes it;
- ``smooth_bf16_fwd``, ``smooth_bf16_feats``: as the two above, with
  every ReLU of the reference made a GELU on both sides of the
  comparison (the float32 reference too).

Each run prints one JSON line a seed and variant: the check's numbers
(``checks.train_gaps`` and ``bn_var_gap``) and ``layers``: at the first
step, for each train-mode BatchNorm in the order of the forward, the
relative L2 gaps to the reference's of its input and of the gradients
at its output and its input, and the reference's cancellation in its
backward (:class:`Taps`); ``leaves``: each leaf's gaps (:func:`_leaves`); for the reference's
variants, with ``--ops``, ``ops``: at the first step, op by op in the order of the
backward (each ReLU and the statistics pooling), the gaps of its input
and of the gradients at its output and input, and for a ReLU the share
of its gates that the variant flips, the share of its input gradient's
error at those gates and the share of the reference's gradient there
(:class:`OpTaps`). ``--mix`` overrides numbers of the cell's traffic mix
(JSON).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = ("program", "k1_f32", "trunk_f32", "program_f32", "ref_bf16", "ref_bf16_fwd", "ref_bf16_feats",
            "ref_fp8", "smooth_bf16_fwd", "smooth_bf16_feats")


def _bf16(torch, backward: bool):
    """A quantiser (``reference.ops``' ``q``) that rounds to bfloat16, and
    with ``backward`` the gradient on the way back too."""

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return y.to(torch.bfloat16).float()

        @staticmethod
        def backward(ctx, g):
            return g.to(torch.bfloat16).float() if backward else g

    return lambda x: Round.apply(x) if x.requires_grad else x.to(torch.bfloat16).float()


def _leaves(got, ref, w, buffers, torch) -> dict:
    """Each leaf's [gradient's gap of norms, gradient's error, change's
    gap of norms], each over the reference's norm of that leaf."""
    out = {}
    for k in ref["grad1"]:
        n = lambda t: float(torch.linalg.vector_norm(t.double()))
        g, r = got["grad1"][k], ref["grad1"][k]
        dg, dr = got["params3"][k].double() - w[k].double(), ref["params3"][k].double() - w[k].double()
        out[k] = [abs(n(g) - n(r)) / n(r), n(g.double() - r.double()) / n(r), abs(n(dg) - n(dr)) / n(dr)]
    return out


class Taps:
    """Each train-mode BatchNorm's input x, the gradient that reaches its
    output (g_out) and the one it passes to its input (g_in) at the first
    step, by the BN's name in the reference. For the reference also the
    BN's share of cancellation: ||g_out * scale / sigma|| / ||g_in||, the
    gradient as a BN with fixed statistics would pass it over the one the
    batch statistics leave, which is its part orthogonal to the
    channel's mean and its normalised input."""

    def __init__(self):
        self.x, self.g_in, self.g_out, self.gain, self.on = {}, {}, {}, {}, True

    def take(self, name, x, y, gain=None):
        if not self.on:
            return
        self.x[name] = x.detach().float()
        if x.requires_grad:
            x.register_hook(lambda g: self.g_in.__setitem__(name, g.detach().float()))
        if y.requires_grad:
            y.register_hook(lambda g: self.g_out.__setitem__(name, g.detach().float()))
        if gain is not None:
            self.gain[name] = gain

    def cancellation(self, name, torch):
        shape = (1, -1) + (1,) * (self.g_out[name].dim() - 2)
        fixed = self.g_out[name] * self.gain[name].view(shape)
        return float(torch.linalg.vector_norm(fixed) / torch.linalg.vector_norm(self.g_in[name]))

    def gaps(self, ref: "Taps", torch) -> list:
        """[name, x's gap, g_out's gap, g_in's gap, the reference's
        cancellation] a BN, each gap ||a - r|| / ||r||."""
        def rel(a, b, k):
            if k not in a or k not in b:
                return None
            return float(torch.linalg.vector_norm(a[k] - b[k]) / torch.linalg.vector_norm(b[k]))

        return [[k, rel(self.x, ref.x, k), rel(self.g_out, ref.g_out, k), rel(self.g_in, ref.g_in, k),
                 ref.cancellation(k, torch) if k in ref.gain and k in ref.g_in else None]
                for k in ref.x if k in self.x]


class OpTaps:
    """Each ReLU's and the statistics pooling's input and the gradients at
    its output and input, at the first step, in the order of the forward."""

    def __init__(self):
        self.ops, self.on = [], True

    def take(self, kind, x, y):
        if not self.on:
            return
        # kept on the host: at a cell's size the ops of two runs outgrow the card
        rec = {"kind": kind, "x": x.detach().float().cpu()}
        self.ops.append(rec)
        if x.requires_grad:
            x.register_hook(lambda g: rec.__setitem__("g_in", g.detach().float().cpu()))
        if y.requires_grad:
            y.register_hook(lambda g: rec.__setitem__("g_out", g.detach().float().cpu()))

    def gaps(self, ref: "OpTaps", torch) -> list:
        """[index, kind, shape, x's gap, g_out's gap, g_in's gap, flipped
        share, error share at the flips, the reference's gradient share at
        the flips] an op, last op first; each gap ||a - r|| / ||r||."""
        rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
        out = []
        for i in reversed(range(min(len(self.ops), len(ref.ops)))):
            g, r = self.ops[i], ref.ops[i]
            row = [i, r["kind"], list(r["x"].shape), rel(g["x"], r["x"]),
                   rel(g["g_out"], r["g_out"]) if "g_out" in g and "g_out" in r else None,
                   rel(g["g_in"], r["g_in"]) if "g_in" in g and "g_in" in r else None, None, None, None]
            if r["kind"] == "relu" and row[5] is not None:
                flip = (r["x"] > 0) != (g["x"] > 0)
                err, energy = (g["g_in"] - r["g_in"]) ** 2, r["g_in"] ** 2
                row[6:] = [float(flip.float().mean()), float(err[flip].sum() / err.sum()),
                           float(energy[flip].sum() / energy.sum())]
            out.append(row)
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--mix", default="{}")
    parser.add_argument("--ops", action="store_true", help="the reference's variants op by op (``ops``)")
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness, program, reference, traffic_gen, weights
    from benchmark.reference import resnet_xvector
    from benchmark.reference.ops import fp8_round

    cell = harness.resolve(harness.load_spec(REPO), args.workload, REPO)
    drv, cfg, mix = cell.driver, cell.config, dict(cell.traffic, **json.loads(args.mix))
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    fam = reference.family(cfg["reference"])
    opt = cfg["optimizer"]
    low = getattr(torch, cfg["dtype"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    plain_bn = resnet_xvector.batch_norm
    taps_now = [None]

    def tapped_bn(P, pre, x, mask=None, train=False, q=None):
        y = plain_bn(P, pre, x, mask, train, q)
        if taps_now[0] is not None and train:
            dims = (0,) + tuple(range(2, x.dim()))
            var = x.detach().var(dims, unbiased=False)
            taps_now[0].take(pre, x, y, P[pre + ".scale"].detach() * torch.rsqrt(var + reference.ops.BN_EPS))
        return y

    resnet_xvector.batch_norm = tapped_bn
    plain_features = reference.fbank.features

    def program_steps(w, waves, labels, k1_dtype, trunk_dtype, taps):
        from asv_subtools_tpu_torch.features.fused_fbank import wave_features
        from asv_subtools_tpu_torch.nn.norm import BatchNorm
        from asv_subtools_tpu_torch.train import (TrainStepConfig, get_lr_schedule, get_optimizer,
                                                  init_train_state, make_train_step)

        net = program.build(cfg, dev, w, with_head=True)
        tx = get_optimizer(opt["name"], learning_rate=get_lr_schedule(**cfg["lr_schedule"]),
                           **{k: v for k, v in opt.items() if k not in ("name", "max_change")})
        state = init_train_state(net, tx, dev)
        step = make_train_step(net, tx, config=TrainStepConfig(max_change=opt["max_change"],
                                                               compute_dtype=trunk_dtype))
        hooks = [m.register_forward_hook(lambda m, inp, out, n=n[len("backbone."):]: taps.take(n, inp[0], out))
                 for n, m in net.named_modules() if isinstance(m, BatchNorm)]
        gen, losses = torch.Generator(device=dev), []
        for i in range(drv.CHECK_STEPS):
            with torch.no_grad():
                feats, _ = wave_features(waves[i], None, program.fbank_options(cfg), k1_dtype)
            state, metrics = step(state, {"x": feats, "y": labels[i]}, gen)
            losses.append(float(metrics["loss"]))
            taps.on = False
            if i == 0:
                trace1, stats1 = state.opt_state["trace"], state.batch_stats
        for h in hooks:
            h.remove()
        grad1 = {k: v - opt["weight_decay"] * w[k] for k, v in trace1.items()}
        return {"losses": losses, "grad1": grad1, "params3": state.params, "stats1": stats1}

    def reference_steps(w, buffers, waves, labels, q, taps, round_feats=False, ops=None):
        taps_now[0] = taps
        relu, stats = torch.relu, getattr(fam, "statistics", None)
        if ops is not None:
            torch.relu = lambda x: (lambda y: (ops.take("relu", x, y), y)[1])(relu(x))
            if stats is not None:
                fam.statistics = lambda h, m: (lambda z: (ops.take("stats", h, z), z)[1])(stats(h, m))
        if round_feats:
            reference.fbank.features = lambda *a: (lambda f, m: (f.to(torch.bfloat16).float(), m))(
                *plain_features(*a))
        try:
            params = {k: v.float() for k, v in w.items() if k not in buffers}
            state, losses, grad1, stats1 = {}, [], None, {}
            for i in range(drv.CHECK_STEPS):
                params, clipped, state, loss = reference.train_step(
                    fam, params, buffers, waves[i], labels[i], cfg, state, q,
                    batch_stats=stats1 if i == 0 else None)
                taps.on = False
                if ops is not None:
                    ops.on = False
                losses.append(float(loss))
                grad1 = clipped if grad1 is None else grad1
        finally:
            taps_now[0], reference.fbank.features = None, plain_features
            torch.relu = relu
            if stats is not None:
                fam.statistics = stats
        return {"losses": losses, "grad1": grad1, "params3": params, "stats1": stats1}

    for seed in (int(s) for s in args.seeds.split(",") if s):
        w = weights.seeded_tensors(drv._specs(cfg, fam), traffic_gen.derived_seed(seed, 0), dev, torch.float32)
        gen = torch.Generator(device=dev).manual_seed(traffic_gen.derived_seed(seed, 1))
        b, s = mix["batch"], traffic_gen.chunk_samples(mix)
        waves = traffic_gen.device_waves(mix, (drv.CHECK_STEPS, b, s), gen, dev)
        labels = torch.randint(0, cfg["head"]["num_targets"], (drv.CHECK_STEPS, b), generator=gen, device=dev)
        buffers = {k: v for k, v in w.items() if k.endswith((".mean", ".var"))}
        ref_taps, ref_ops = Taps(), OpTaps() if args.ops else None
        ref = reference_steps(w, buffers, waves, labels, None, ref_taps, ops=ref_ops)
        for variant in args.variants.split(","):
            t0, taps, base, base_taps = time.perf_counter(), Taps(), ref, ref_taps
            ops, base_ops = None, ref_ops
            if variant.startswith(("ref_", "smooth_")):
                kind = variant.split("_", 1)[1]
                q = {"bf16": _bf16(torch, True), "bf16_fwd": _bf16(torch, False), "fp8": fp8_round}.get(kind)
                relu = torch.relu
                if variant.startswith("smooth_"):
                    # the reference's ReLUs made smooth on both sides: its gradient
                    # then no longer jumps where a perturbed activation crosses 0
                    torch.relu, base_taps = torch.nn.functional.gelu, Taps()
                    base_ops = OpTaps() if args.ops else None
                ops = OpTaps() if args.ops else None
                try:
                    if variant.startswith("smooth_"):
                        base = reference_steps(w, buffers, waves, labels, None, base_taps, ops=base_ops)
                    got = reference_steps(w, buffers, waves, labels, q, taps, round_feats=kind == "bf16_feats",
                                          ops=ops)
                finally:
                    torch.relu = relu
                got["stats1"] = drv._running(got["stats1"], buffers, cfg, fam)
            else:
                k1, trunk = {"program": (low, low), "k1_f32": (torch.float32, low), "trunk_f32": (low, torch.float32),
                             "program_f32": (torch.float32, torch.float32)}[variant]
                got = program_steps(w, waves, labels, k1, trunk, taps)
            notes = []
            compared = drv._compare(got, base, w, buffers, cfg, fam, notes)
            print(json.dumps({"seed": seed, "variant": variant, "compared": compared,
                              "layers": taps.gaps(base_taps, torch), "leaves": _leaves(got, base, w, buffers, torch),
                              "ops": ops.gaps(base_ops, torch) if ops is not None else None, "notes": notes,
                              "wall_s": time.perf_counter() - t0}), flush=True)
            del got, taps, ops
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
