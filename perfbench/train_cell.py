"""A staged-training cell: ``Trainer.train_batch`` of the program on
batches already on the device, round-robin over the traffic's tasks.

Set-up builds one Trainer from the seed's weights and drives it through
its first round (``compare_steps`` steps, each on rows of its own), which
also builds every kernel and shape of the window; it reads the program's
numbers of those steps there (each step's loss, each leaf's first gradient
as the optimizer got it, worked out from its first moment after one step,
and each leaf's change over the steps), runs ``warm_rounds`` more rounds
and hands the same Trainer to the window. The window runs whole rounds
until ``--seconds`` have passed and ends on a read of the last step's
loss: ``train_img_s`` is the images of all its steps over its length.
After the window the program's state is freed and the reference follows
the same steps from the same weights, batches and generator seed
(``compare.py``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from perfbench import compare, core, traffic as traffic_lib
from perfbench.weights import make_weights, reference_template

B1 = 0.9  # the optimizer's first-moment decay (optax scale_by_adam)


def _leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors])


def _to_host(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """name -> the tensor as f32 on the host, in one copy."""
    if not named:
        return {}
    flat = torch.cat([t.float().reshape(-1) for t in named.values()]).cpu()
    return {n: piece.view(t.shape) for (n, t), piece in zip(
        named.items(), torch.split(flat, [t.numel()
                                          for t in named.values()]))}


def program_state(trainer) -> Dict:
    """The optimizer's leaves: names, first moments and parameters."""
    names, mus, params = [], [], []
    for (_, ps), ns, ms in zip(trainer.optimizer.groups,
                               trainer._opt_names,
                               trainer.optimizer.buffers["mu"]):
        names += ns
        mus += ms
        params += ps
    return {"names": names, "mu": mus, "params": params}


def first_gradient(trainer) -> Dict[str, float]:
    """name -> the norm of the first step's gradient of every leaf: the
    optimizer's leaves from their first moment (as the optimizer got it),
    the others (frozen, their gradient computed and clipped) from
    ``.grad``."""
    st = program_state(trainer)
    opt = set(st["names"])
    rest = [(n, p.grad) for n, p in trainer._named if n not in opt]
    names = st["names"] + [n for n, _ in rest]
    norms = _leaf_norms([m / (1.0 - B1) for m in st["mu"]]
                        + [g for _, g in rest])
    return dict(zip(names, norms.tolist()))


class TrainCell:
    """One run of a ``train_staged`` cell (module docstring). ``fault``
    names a planted fault for the tests (``compare.FAULTS``)."""

    def __init__(self, bench_cell: Dict, config_file: Dict, traffic: Dict,
                 seed: int, device: str = "cuda", fault: str = None):
        from fmc_uia_tpu_torch.config import Config
        from fmc_uia_tpu_torch.tasks import TaskRegistry

        self.cell = bench_cell
        self.config_dict = config_file["config"]
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.config = Config(config_dict=self.config_dict)
        self.registry = TaskRegistry.from_config(self.config)
        self.types = len(traffic["tasks"])
        self.B = int(traffic["batch"])
        self.compare_steps = int(traffic["compare_steps"])

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from fmc_uia_tpu_torch.models import build_model
        from fmc_uia_tpu_torch.train import Trainer

        from perfbench.reference.config import Config as RefConfig
        from perfbench.reference.tasks import TaskRegistry as RefRegistry

        clock = core.Phases()
        ref_cfg = RefConfig(config_dict=self.config_dict)
        template = reference_template(ref_cfg, RefRegistry.from_config(
            ref_cfg), self.device)
        weights = make_weights(template, self.seed, self.device)
        del template
        clock.mark("weights")
        dtype = (torch.bfloat16 if self.config.mixed_precision
                 else torch.float32)
        model = build_model(self.config, self.registry, dtype=dtype,
                            device=self.device, init=False)
        model.load_state_dict(weights, strict=True)
        trainer = Trainer(self.config, model, self.registry,
                          device=self.device, seed=self.seed)
        self._unplant = compare.plant(self.fault, trainer)
        self.trainer, self.model = trainer, model
        self.pool = traffic_lib.train_pool(self.traffic, self.registry,
                                           self.seed, self.device)
        clock.mark("model")
        losses = []
        for i in range(self.compare_steps):
            logs = trainer.train_batch(self.pool[i % len(self.pool)], 0)
            losses.append(logs["total_loss"].float())
            if i == 0:
                g1 = first_gradient(trainer)
                norm1 = logs.get("grad_norm")
        st = program_state(trainer)
        with torch.no_grad():
            delta = _to_host({n: p.float() - weights[n] for n, p in
                              zip(st["names"], st["params"])})
        self.program = {"names": [n for n, _ in trainer._named],
                        "opt": st["names"],
                        "loss": torch.stack(losses).cpu().tolist(),
                        "g1": g1, "delta": delta}
        if norm1 is not None:
            self.program["norm1"] = float(norm1)
        del weights, st
        clock.mark("compared_steps")
        self.step = self.compare_steps
        self._last = losses[-1]
        for _ in range(int(self.traffic["warm_rounds"]) * self.types):
            self._one()
        float(self._last)  # the warm-up has finished on the device
        clock.mark("warm_up")
        self.phases = clock.seconds

    def _one(self) -> None:
        """The next step of the round-robin over the pool."""
        b = self.pool[self.step % len(self.pool)]
        self._last = self.trainer.train_batch(b, 0)["total_loss"]
        self.step += 1

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        """Whole rounds until ``seconds`` have passed, ended on a read of
        the last step's loss."""
        core.sync(self.device)
        core.reset_peak(self.device)
        losses, steps = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(self.types):
                self._one()
                losses.append(self._last)
                steps += 1
        last = float(losses[-1])  # the window ends on a read of the loss
        wall = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses).float())).sum())
        return {"steps": steps, "images": steps * self.B, "window_s": wall,
                "train_img_s": steps * self.B / wall, "last_loss": last,
                "nonfinite": bad,
                "peak_bytes": core.peak_bytes(self.device)}

    def traced(self, rounds: int) -> Dict:
        """After the window: the profiler warms up over one round, then
        records ``rounds`` rounds (``trace.py``)."""
        from perfbench.trace import Trace

        trace = Trace(torch)
        trace.start()
        for _ in range(self.types):
            self._one()
        trace.begin()
        c0 = launch_counters()
        for _ in range(rounds * self.types):
            self._one()
        trace.end()
        c1 = launch_counters()
        steps = rounds * self.types
        return {"trace": trace.reduce(), "steps": steps,
                "images": steps * self.B,
                "launches": {k: c1[k] - c0[k] for k in c1},
                "img_s": steps * self.B / trace.window_s}

    def enqueue_ms(self, rounds: int = 2) -> float:
        """Host ms of one ``train_batch`` with the card idle, the mean over
        ``rounds`` rounds of the tasks (the step's host work, and any wait
        it makes on the card)."""
        vals = []
        for _ in range(rounds * self.types):
            core.sync(self.device)
            t0 = time.perf_counter()
            self._one()
            vals.append(1e3 * (time.perf_counter() - t0))
        core.sync(self.device)
        return sum(vals) / len(vals)

    def free(self) -> None:
        del self.trainer, self.model, self.pool
        self._last = None
        self._unplant()
        core.free_cache(self.device)

    # -- the comparison -------------------------------------------------------
    def reference(self, control: bool = False) -> Dict:
        """The reference's numbers of the same steps (f32, TF32 off; with
        ``control`` its forward in float8, ``reference/step.py``), in the
        form ``compare.train_numbers`` reads."""
        from perfbench.reference.config import Config as RefConfig
        from perfbench.reference.multitask import build_model
        from perfbench.reference.step import Fp8Forward, RefTrainer
        from perfbench.reference.tasks import TaskRegistry as RefRegistry

        cfg = RefConfig(config_dict=self.config_dict)
        registry = RefRegistry.from_config(cfg)
        with compare.no_tf32():
            template = reference_template(cfg, registry, self.device)
            weights = make_weights(template, self.seed, self.device)
            del template
            model = build_model(cfg, registry, dtype=torch.float32,
                                device=self.device)
            model.load_state_dict(weights, strict=True)
            rt = RefTrainer(cfg, model, registry, seed=self.seed)
            pool = traffic_lib.train_pool(self.traffic, registry, self.seed,
                                          self.device)
            named = dict(model.named_parameters())
            opt = list(rt.opt_leaf_names)
            gabs = {n: torch.zeros_like(named[n]) for n in opt}
            losses, per_step = [], []
            for i in range(self.compare_steps):
                with Fp8Forward() if control else contextlib.nullcontext():
                    r = rt.step(pool[i % len(pool)])
                losses.append(r["total_loss"])
                per_step.append(r["grad_norms"].cpu())
                for n in opt:
                    torch.maximum(gabs[n], named[n].grad.abs(),
                                  out=gabs[n])
                if i == 0:
                    norm1 = r["norm"]
            with torch.no_grad():
                delta = _to_host({n: named[n] - weights[n] for n in opt})
            gabs = _to_host(gabs)
        names = list(rt.names)
        out = {"names": names, "opt": opt, "loss": losses,
               "g1": dict(zip(names, per_step[0].tolist())),
               "gmax": dict(zip(names, torch.stack(per_step).amax(0)
                                .tolist())),
               "delta": delta, "gabs": gabs, "norm1": norm1}
        del model, rt, weights, pool, named
        core.free_cache(self.device)
        return out


def launch_counters() -> Dict[str, int]:
    """The kernel wrappers' ``.launches`` counters, by kernel id."""
    from fmc_uia_tpu_torch.ops import swin_block as sb
    from fmc_uia_tpu_torch.ops import vit_attention as va

    return {"K1f": sb.attention_branch.launches,
            "K1b": sb.attention_branch_backward.launches,
            "K2f": sb.mlp_branch.launches,
            "K2b": sb.mlp_branch_backward.launches,
            "K4f": va.global_attention.launches,
            "K4b": va.global_attention_backward.launches}
