"""The default fine-tune step, back to back: ``make_train_step``'s ``step``
over seeded uint8 batches copied from the host each step (as the port's
``_HostFeed`` does), with the train augment's draws from a seeded CPU
generator a step.

Set-up builds the one step object (the model holding the seeded weights,
the lock mask, the frozen prefix's pack, Adam) and drives it through its
first ``checked_steps`` steps on distinct batches: those steps go through
the window's own call and feed, and the plain reference follows them.
The window then goes on with the same object.

Traffic keys: ``batch``, ``image_size`` (the uint8 side), ``classes``,
``lr``, ``unlocked_groups``, ``tune_text``, ``unlocked_text_layers``,
``pool_batches``, ``checked_steps``, ``trace_items`` and ``label_items``
(steps in the two traced segments of a ``--trace 1`` run).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import checks, harness, system
from benchmark.images import smooth_images
from benchmark.reference import towers
from benchmark.reference.train import frozen_blocks, train_steps

BETA1 = 0.9


class Loop:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.attempted = self.failed = 0
        self.losses = []

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            harness.seed_mix(self.run.seed, 10, step))

    def _settings(self):
        return {k: self.t[k] for k in ("lr", "unlocked_groups", "tune_text",
                                       "unlocked_text_layers")}

    def setup(self):
        from aihab_clip_tpu_torch.models import build_text_head
        from aihab_clip_tpu_torch.templates import gen_prompts
        from aihab_clip_tpu_torch.train import peft

        run, cfg, t = self.run, self.run.cfg, self.t
        dev = torch.device(run.device)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        weights = towers.make_weights(cfg, run.seed, dev)
        model, pcfg = system.port_model(cfg, weights, dev, dtype)
        self.model = model
        prompts, per = gen_prompts(use_hierarchy=True, use_descriptive=True)
        n_cls = len(prompts) // per
        tokens = build_text_head(model, prompts, n_cls, per,
                                 context_length=pcfg.context_length
                                 )["prompt_tokens"]
        peft.build_lock_mask(model, pcfg.vision_layers,
                             pcfg.transformer_layers,
                             unlocked_groups=t["unlocked_groups"],
                             tune_text=t["tune_text"],
                             unlocked_text_layers=t["unlocked_text_layers"])
        self.names = [n for n, p in model.named_parameters()
                      if p.requires_grad]
        self.params = [model.get_parameter(n) for n in self.names]
        n_prefix = peft.peft_fused_prefix_len(pcfg, t["unlocked_groups"], dev)
        self.pcfg = peft.PEFTConfig(
            resolution=pcfg.image_resolution, num_classes=n_cls, lr=t["lr"],
            epochs=1, crop_mode="random", flip=False, rotation=True,
            tune_text=t["tune_text"], num_templates=per,
            compute_dtype=dtype, fused_prefix=n_prefix,
            prefix_quant=run.options.get("control") == "int8")
        self.opt, self.step = peft.make_train_step(model, self.pcfg, None,
                                                   tokens)
        self.pprefix = (peft._quantize_prefix(model, self.pcfg)
                        or peft._pack_prefix(model, self.pcfg))
        self.upload = lambda a: peft.upload(a, dev)
        run.counters.update(frozen_blocks=frozen_blocks(
            cfg, t["unlocked_groups"]), prompts=len(prompts))
        # the host data: distinct seeded batches, made on the device
        gen = torch.Generator(device=dev).manual_seed(
            harness.seed_mix(run.seed, 2))
        d, b = t["image_size"], t["batch"]
        self.images = smooth_images(gen, (t["pool_batches"], b, d, d, 3),
                                    dev).cpu().numpy()
        self.labels = torch.randint(0, n_cls, (t["pool_batches"], b),
                                    generator=gen, device=dev,
                                    dtype=torch.int32).cpu().numpy()
        self.valid = np.ones(b, bool)
        if run.options.get("fault") == "half_batch":
            self.valid[b // 2:] = False
        self.lr = 0.0 if run.options.get("fault") == "frozen" else t["lr"]
        start = {n: weights[n] for n in self.names}
        del weights
        self._checked(start)

    def _one(self, step: int):
        i = step % len(self.images)
        batch = (self.upload(self.images[i]), self.upload(self.labels[i]),
                 self.upload(self.valid))
        with self.run.span("step"):
            out = self.step(*batch, self._generator(step), self.lr,
                            self.pprefix)
        return out["loss"]

    def _checked(self, start):
        """The first steps, read for the comparison: each loss, the first
        gradient as Adam got it (its first moment over 1 - beta1) and the
        change of every trainable leaf after the last."""
        losses = []
        for step in range(self.t["checked_steps"]):
            losses.append(self._one(step))
            if step == 0:
                grads = {n: (self.opt.state[p]["exp_avg"] / (1 - BETA1)).cpu()
                         for n, p in zip(self.names, self.params)}
                if self.run.options.get("look"):
                    self.look = self._first_step_look(start)
        change = torch.stack([(p.detach() - start[n].float()).norm()
                              for n, p in zip(self.names, self.params)])
        self.prog = {"losses": [float(x) for x in losses],
                     "grads": grads,
                     "first_grad": {n: float(g.norm())
                                    for n, g in grads.items()},
                     "change": dict(zip(self.names, change.tolist())),
                     "trainable": list(self.names)}
        self.next_step = self.t["checked_steps"]

    def _first_step_look(self, start):
        """After the first step, by kind of leaf: the elements, those the
        step moved by less than half the learning rate, and those whose
        bfloat16 value (what a bfloat16 forward reads) did not change."""
        look = {}
        for n, p in zip(self.names, self.params):
            kind = ("ln" if ".ln" in n else "bias" if n.endswith("bias")
                    else "matrix")
            d = p.detach() - start[n].float()
            row = look.setdefault(kind, [0, 0, 0])
            row[0] += d.numel()
            row[1] += int((d.abs() < self.t["lr"] / 2).sum())
            row[2] += int((p.detach().to(torch.bfloat16)
                           == start[n].to(torch.bfloat16)).sum())
        return {k: {"elements": v[0], "moved_under_half_lr": v[1],
                    "bf16_unchanged": v[2]} for k, v in look.items()}

    def window(self):
        run, b = self.run, self.t["batch"]
        run.trace_begin()
        t_start = time.perf_counter()
        deadline = t_start + run.seconds
        steps = 0
        while time.perf_counter() < deadline:
            self.losses.append(self._one(self.next_step + steps))
            steps += 1
            run.trace_item(steps, steps * b, run.sync)
        run.sync()
        run.trace_end(steps, steps * b, run.sync)
        elapsed = time.perf_counter() - t_start
        self.attempted, self.window_s = steps, elapsed
        self.failed = int((~torch.isfinite(torch.stack(self.losses))).sum())
        return {"train_images_per_s": steps * b / elapsed}

    def release(self):
        del self.model, self.opt, self.step, self.pprefix, self.params
        self.losses = [float(x) for x in self.losses]

    def verify(self):
        run, t = self.run, self.t
        dev = torch.device(run.device)
        params = checks.reference_params(run.cfg, run.seed, dev)
        tokens, n_cls, per = checks.prompt_tokens(run.cfg, dev)
        n = t["checked_steps"]
        batches = [(torch.from_numpy(self.images[i]).to(dev),
                    torch.from_numpy(self.labels[i]).to(dev))
                   for i in range(n)]
        def steps(p):
            return train_steps(run.cfg, p, batches,
                               [self._generator(s) for s in range(n)],
                               tokens, n_cls, per, self._settings())

        ref = steps(params)
        wit = steps(towers.Bf16(params))
        prog = self.prog
        if run.options.get("control") == "fp8":     # the reference in fp8
            prog = steps(towers.Lowered(params))
        if run.options.get("look"):
            self.look_read = {
                "first_step": getattr(self, "look", None),
                "ref_first_small": ref["first_small"],
                "bf16_first_small": wit["first_small"]}
            reads = steps(towers.Bf16(params, reads=True))
            self.look_read["bf16_reads"] = {
                "losses": reads["losses"],
                "vs_ref": checks.compare_train(reads, ref),
                "prog_vs": checks.compare_train(prog, reads)}
            self.look_read["bf16_vs_ref"] = checks.compare_train(wit, ref)
        self.excluded = len(ref["first_grad"]) - len(
            checks.counted_leaves(ref))
        self.losses_read = {"prog_losses": prog["losses"],
                            "ref_losses": ref["losses"],
                            "bf16_losses": wit["losses"]}
        numbers = checks.compare_train(prog, ref)
        numbers.update({f"bf16_{k}": v for k, v in
                        checks.compare_train(prog, wit).items()})
        return numbers

    def report(self):
        return {"steps": self.attempted, "window_s": self.window_s,
                "leaves": len(self.prog["trainable"]),
                "leaves_left_out": getattr(self, "excluded", None),
                **getattr(self, "losses_read", {}),
                **({"look": self.look_read} if hasattr(self, "look_read")
                   else {}),
                "window_loss_last": (self.losses[-1] if self.losses
                                     else math.nan)}
