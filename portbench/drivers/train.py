"""Training: the graphed fused step, ``make_train_step(model, train, B,
steps_per_call)``, called back to back over a dataset resident on the card.

Set-up builds the one step object on the benchmark's weights and data and
drives it through its first `check_steps` calls: the first captures the
step's CUDA graph, and what the calls return and leave in the state is
what the check judges.  The same object then runs the window: calls until
`--seconds` have passed, then a synchronise; the rate is all steps over
all that time.

The check (after the window, the program's state freed): the plain
reference follows the same first steps from the same weights, Adam state,
data and draws (a generator seeded alike, the program's order of draws),
in float32 with TF32 off, and two numbers are compared, each the worst
leaf's gap between the program's norm and the reference's, over the
larger of the reference's norm and the median leaf's:

* ``grad``: each leaf's gradient as Adam holds it after the first step
  (its first moment; with beta1 = 0 the last gradient it applied);
* ``change``: the norm of each leaf's change over the checked steps, the
  worst leaf, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (the generator's head bias under the
  hour softmax, the critic's score bias under the Wasserstein loss: their
  gradients are zero to rounding, so Adam moves them by round-off alone).

Each step's losses are not compared: no control or fault that the rules
admit separates them from a sound run's (PERF.md, section 2).

No cell of ``BENCHMARK.json`` runs this driver yet: the fp8 control fails
neither number, so the training cells wait for one that it fails (PERF.md,
section 7).  The tests run it on the CPU.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import arith, harness, program, reference, synth, timing
from portbench.trace import run_traced

DEAD_GRAD = 1e-3   # a leaf under this share of the median leaf's gradient
WARM_STEP = 10     # Adam's step count handed to both sides
MOMENT_BATCH = 8   # the batch Adam's second moments are estimated on


def setup_data(r: harness.Run):
    """The resident fields and their valid rows, from the seed."""
    cfg = r.config
    ny, nx = cfg["dataset_grid"]
    return synth.make_dataset(cfg["dataset_days"], ny, nx,
                              cfg["model"]["nhours"], harness.mix(r.seed, 1),
                              cfg["data"], r.device)


def _norm(t: torch.Tensor) -> float:
    return t.detach().float().norm().item()


def hyper(r: harness.Run) -> dict:
    return dict(r.config["train"], batch_size=r.traffic["batch_size"])


def moments(r: harness.Run, w, data, rows):
    """Adam's warm state handed to the program and the reference alike:
    WARM_STEP steps taken, and each leaf's second moment the mean square
    of its gradient in the plain model at the start (float32, a batch of
    MOMENT_BATCH drawn from the seed).  A cold Adam's first update is
    lr * sign(g), which turns rounding in the near-zero gradients into
    whole steps; a warm one moves each weight in proportion to its
    gradient, as a resumed run does."""
    est = reference.Trainer(w, r.config["model"], r.config["data"],
                            dict(hyper(r), batch_size=MOMENT_BATCH), data,
                            rows, harness.mix(r.seed, 8))
    v = est.mean_square_gradients()
    return WARM_STEP, {k: max(x, 1e-30) for k, x in v.items()}


def run(r: harness.Run) -> dict:
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.ops.upsample_conv import upsample2_conv3
    from prdisagg_torch.train.state import (
        create_train_state,
        load_state,
        state_tree,
    )
    from prdisagg_torch.train.wgan_gp import make_train_step

    cfg, traffic, cell = r.config, r.traffic, r.cell
    model, tr_cfg = cfg["model"], hyper(r)
    dtype, k = traffic["compute_dtype"], traffic["steps_per_call"]
    dev = torch.device(r.device)
    data, rows = setup_data(r)
    w = reference.make_weights(model, harness.mix(r.seed, 3), dev)
    draw_seed = harness.mix(r.seed, 4)

    mc = program.model_config(model, dtype)
    tc = program.train_config(cfg["train"])
    ds = DeviceDataset.from_tensor(data, rows, program.data_config(cfg["data"]))
    state = create_train_state(mc, tc, seed=harness.mix(r.seed, 5),
                               device=dev)
    t_ref = time.perf_counter()
    warm = moments(r, w, data, rows)
    ref_s = time.perf_counter() - t_ref
    tree = state_tree(state)
    tree["gen"] = program.generator_state(w)
    tree["critic"] = program.critic_state(w)
    for net in ("gen", "critic"):
        tree[f"{net}_opt"] = [
            {"step": torch.tensor(float(warm[0])),
             "exp_avg": torch.zeros_like(p),
             "exp_avg_sq": torch.full_like(
                 p, warm[1][program.leaf_name(net, n)])}
            for n, p in getattr(state, net).named_parameters()]
    load_state(state, tree)
    state.rng.manual_seed(draw_seed)
    start = {("gen", n): p.detach().clone()
             for n, p in state.gen.named_parameters()}
    start.update({("critic", n): p.detach().clone()
                  for n, p in state.critic.named_parameters()})
    step = make_train_step(mc, tc, tr_cfg["batch_size"], steps_per_call=k)

    def named():
        for net in ("gen", "critic"):
            for n, p in getattr(state, net).named_parameters():
                yield net, n, p

    def opt(net):
        return state.gen_opt if net == "gen" else state.critic_opt

    got_grad = {}
    for s in range(traffic["check_steps"]):
        _, m = step(state, ds)
        if s == 0:
            got_grad = {program.leaf_name(net, n):
                        _norm(opt(net).state[p]["exp_avg"])
                        for net, n, p in named()}
    got_change = {program.leaf_name(net, n): _norm(p.detach() - start[(net, n)])
                  for net, n, p in named()}
    del start
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the reference's estimate of Adam's moments is the check's input, not
    # the program's set-up
    setup_s = time.perf_counter() - r.t_start - ref_s

    flags, calls = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        _, m = step(state, ds)
        flags.append(m["nonfinite"])
        calls += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    failed = int(torch.stack(flags).sum().item()) if flags else 0
    facts = program.device_facts(r.device)

    tr, k1 = None, []
    if r.trace:
        tr = run_traced(lambda: step(state, ds), cell["trace_calls"])
        if tr is not None:
            tr.units *= k
        if dev.type == "cuda":
            for case in arith.k1_train_cases(model, tr_cfg["batch_size"],
                                             tr_cfg["n_disc"], dtype):
                k1.append((arith.k1_case_bound_ms(case),
                           timing.k1_case_ms(upsample2_conv3, case,
                                             cell["k1_reps"],
                                             harness.mix(r.seed, 7))))
    del step, state, ds, m
    program.free(r.device)

    got = {"grad": got_grad, "change": got_change}
    checks = check(r, w, data, rows, draw_seed, warm, got)
    facts.update(
        setup_s=setup_s, window_s=window_s, units=calls * k, trace=tr, k1=k1,
        flops_per_unit=arith.step_flops(model, tr_cfg["batch_size"],
                                        tr_cfg["n_disc"]),
        peak_flops=arith.peak_flops(dtype), attempted=calls * k,
        failed=failed, checks=checks, kind_of_cell="train")
    return facts


def follow(r: harness.Run, w, data, rows, draw_seed, warm,
           prec="f32") -> dict:
    """The reference's (or a control's) readings over the checked steps:
    the norm of each leaf's gradient as Adam holds it after the first step
    and of its change over all of them."""
    ref = reference.Trainer(w, r.config["model"], r.config["data"], hyper(r),
                            data, rows, draw_seed, prec, warm)
    out = {"grad": {}}
    for s in range(r.traffic["check_steps"]):
        ref.step()
        if s == 0:
            out["grad"] = {k: _norm(v) for k, v in ref.exp_avg().items()}
    out["change"] = {k: _norm(v.detach() - w[k]) for k, v in ref.w.items()}
    return out


def gaps(got: dict, want: dict) -> dict:
    """The compared numbers of `got` against `want` (both as
    :func:`follow` returns them): ``grad`` and ``change``, each the worst
    leaf's gap of norms over the larger of its reference norm and the
    median leaf's."""
    grad_med = statistics.median(want["grad"].values())
    live = [n for n, v in want["grad"].items() if v >= DEAD_GRAD * grad_med]

    def worst(key, names):
        med = statistics.median(want[key][n] for n in names)
        return max(abs(got[key][n] - want[key][n]) / max(want[key][n], med)
                   for n in names)

    return {"grad": worst("grad", list(want["grad"])),
            "change": worst("change", live)}


def check(r: harness.Run, w, data, rows, draw_seed, warm, got: dict) -> dict:
    g = gaps(got, follow(r, w, data, rows, draw_seed, warm))
    limits = r.cell["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in g.items()}
