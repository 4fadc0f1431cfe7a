"""The paper's motivating example (Fig. 1b / §2): an RL loop where parallel
simulations feed policy updates, built on futures + wait + a stateful
policy actor, with optional fault injection. The port of
`examples/rl_pipeline.py` onto `repro_torch.core`: the policy and its
gradient step run in PyTorch on the card, the rollouts stay numpy on the
host.

Run:  PYTHONPATH=src python -m repro_torch.examples.rl_pipeline \
          [--kill-node] [--eager] [--iters N] [--device cpu]

A tiny REINFORCE-style agent learns a bandit-ish task. The policy lives in
a `PolicyLearner` *actor*: rollout batches stream into `update` method
calls (ordered method futures — updates apply in submission order even
though nothing blocks), and each generation of simulations takes the
latest `weights()` *future* as its argument, so the dataflow graph wires
actor state straight into downstream tasks. Rollouts are remote CPU tasks
(heterogeneous durations) consumed in completion order (wait), so
stragglers never stall the learner; `--kill-node` lands on the learner's
node, so the actor restarts elsewhere and replays its update log (or
restores its `__getstate__` checkpoint), rebuilding its weights on its
device from numpy.

The hot loop runs as a *compiled graph* by default: the per-iteration
shape — `update(batch)` then `weights()` then a generation of
`simulate(w, seed)` fan-out — is bound once (`bind`), compiled once
(`dag.compile`), and replayed every iteration (`cg.execute(batch,
*seeds)`), so each step pays ONE batched control-plane registration
instead of one round per task. `--eager` runs the original
submit-per-task loop for comparison; both train the same policy.

The fleet is heterogeneous (`node_resources=`): two nodes declare a
"gpu" unit and two are cpu-only. The learner actor requests
`{"gpu": 1}` via `.options()`, so it lands only on a device-typed node
(and can still fail over: the second gpu node catches the actor
restart under `--kill-node`), while rollouts stay on the cpu fleet.
The actor's methods run on its mailbox lane; its tensors live on
`--device` (the card unless `--device cpu`), which the example prints at
the end. Every 10 iterations the driver publishes the current policy as a
versioned `ParamSet` — the weight hot-swap handle an external serving
tier would poll — and verifies the zero-copy fetch round-trips.

The reference initialises the policy from `jax.random.PRNGKey(0)`, which
no torch generator reproduces; the port draws its own from a seeded
`torch.Generator`, and `policy_from_numpy` takes the reference's weights
(its `weights()`, a numpy dict) into the port's.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import core, dag
from repro_torch.compute import ParamSet
from repro_torch.device import DeviceLike, resolve_device

#: The policy's step size, as in the reference.
LR = 0.05


def policy_from_numpy(w: Dict[str, np.ndarray], device: DeviceLike = None
                      ) -> Dict[str, torch.Tensor]:
    """A numpy policy dict ({"w1": (8, 32), "w2": (32, 2)}) — the
    reference's or the port's `weights()`, or a checkpoint — as fp32
    tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in w.items()}


def policy_to_numpy(w: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in w.items()}


def make_policy(device: DeviceLike = None, seed: int = 0):
    """(weights, act, update) of an 8 -> 32 -> 2 tanh MLP on `device`:
    weights drawn from a seeded `torch.Generator` on the host, `update`
    one gradient step of the policy-gradient loss by autograd."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    w = {"w1": torch.randn(8, 32, generator=gen) * 0.3,
         "w2": torch.randn(32, 2, generator=gen) * 0.3}
    w = {k: v.to(dev) for k, v in w.items()}

    def act(w, obs):
        h = torch.tanh(obs @ w["w1"])
        return torch.tanh(h @ w["w2"])

    def update(w, obs, actions, rewards):
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        pred = act(leaves, obs)
        adv = rewards - rewards.mean()
        loss = -torch.mean(torch.sum(pred * actions, -1) * adv)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            return {k: p - LR * g
                    for (k, p), g in zip(leaves.items(), grads)}

    return w, act, update


@core.remote(checkpoint_interval=8)
class PolicyLearner:
    """Stateful policy owner: consumes rollout batches, emits weights."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.w, self._act, self._update = make_policy(self.device)
        self.updates = 0

    def update(self, batch):
        if not batch:   # a wait() timeout can hand us an empty batch
            return 0.0
        obs = torch.as_tensor(np.stack([b[0] for b in batch]),
                              device=self.device)
        acts = torch.as_tensor(np.stack([b[1] for b in batch]),
                               device=self.device)
        rews = torch.as_tensor(np.array([b[2] for b in batch], np.float32),
                               device=self.device)
        self.w = self._update(self.w, obs, acts, rews)
        self.updates += 1
        return float(rews.mean())

    def weights(self):
        return policy_to_numpy(self.w)

    def stats(self) -> Dict[str, Any]:
        """Where the weights live and how many updates were applied."""
        return {"device": str(self.w["w1"].device), "updates": self.updates}

    def __getstate__(self):
        return {"w": policy_to_numpy(self.w), "updates": self.updates,
                "device": str(self.device)}

    def __setstate__(self, state):
        self.device = resolve_device(state["device"])
        _, self._act, self._update = make_policy(self.device)
        self.w = policy_from_numpy(state["w"], self.device)
        self.updates = state["updates"]


@core.remote
def simulate(w_host, seed):
    """Environment rollout (numpy 'physics'): reward is higher when the
    policy's action aligns with a hidden direction of the observation."""
    rng = np.random.default_rng(seed)
    time.sleep(0.002 + 0.004 * rng.random())
    obs = rng.standard_normal(8).astype(np.float32)
    h = np.tanh(obs @ w_host["w1"])
    action = np.tanh(h @ w_host["w2"])
    target = np.array([np.sign(obs[:4].sum()), np.sign(obs[4:].sum())],
                      dtype=np.float32)
    reward = float(action @ target)
    return obs, action, reward


#: Fresh simulations launched per training step by the compiled loop —
#: the fixed fan-out the step graph is compiled for.
SIMS_PER_STEP = 8


def run(iters: int = 30, kill_node: bool = False, eager: bool = False,
        device: DeviceLike = None) -> Dict[str, Any]:
    """The training loop; returns what `main` reports: whether the policy
    improved, the returns, the learner's device and update count, and
    whether the last `ParamSet` fetch round-tripped (None under 10
    iterations, when nothing was published)."""
    dev = str(resolve_device(device))   # no card: raise before any work
    # heterogeneous fleet: two gpu-typed nodes (learner placement +
    # failover target), two cpu-only rollout nodes
    cluster = core.init(node_resources=[{"cpu": 2.0, "gpu": 1.0}] * 2
                        + [{"cpu": 2.0}] * 2)
    try:
        return _train(cluster, iters, kill_node, eager, dev)
    finally:
        core.shutdown()


def _train(cluster, iters: int, kill_node: bool, eager: bool,
           dev: str) -> Dict[str, Any]:
    learner = PolicyLearner.options(
        resources={"cpu": 1.0, "gpu": 1.0}).submit(dev)

    # compiled step: the whole per-iteration graph — update the policy
    # with this step's batch, read the post-update weights (ordered
    # method futures: the seq block guarantees update-before-weights),
    # and fan a fresh generation of simulations off the weights future.
    # Compiled once; every iteration is one epoch-tagged execute().
    step = None
    if not eager:
        upd = learner.update.bind(dag.input(0))
        w = learner.weights.bind()
        sims = [simulate.bind(w, dag.input(1 + i))
                for i in range(SIMS_PER_STEP)]
        step = dag.compile([upd] + sims)

    returns = []
    w_now: Optional[Dict[str, np.ndarray]] = None
    # the weights *future* feeds simulations directly — actor state as a
    # dataflow dependency, no copy through the driver
    w_ref = learner.weights.submit()
    pending = [simulate.submit(w_ref, s) for s in range(16)]
    for it in range(iters):
        if kill_node and it == iters // 2:
            victim = cluster.gcs.actor_node(learner.actor_id)
            cluster.kill_node(victim)
            print(f"!! killed node {victim} (the learner's node) "
                  "mid-training — actor replay + lineage active")
        # consume in completion order; update on partial batches (R1).
        # A rollout may resolve to a *typed error* under --kill-node
        # (e.g. its weights arg was lost past the actor's checkpoint and
        # cannot be replayed) — skip it, the learner trains on whatever
        # survived, which is exactly the paper's straggler/failure story
        batch = []
        while pending and len(batch) < 12:
            done, pending = core.wait(pending,
                                      num_returns=min(4, len(pending)),
                                      timeout=0.5)
            for r in done:
                try:
                    batch.append(core.get(r))
                except core.TaskError:
                    pass
        if step is not None:
            # one batched dispatch for update + weights + the whole
            # next generation; sink refs are ordinary futures
            refs = step.execute(tuple(batch),
                                *(1000 * it + s
                                  for s in range(SIMS_PER_STEP)))
            ret_ref = refs[0]
            pending += refs[1:]
        else:
            # eager comparison loop: one control-plane round per task
            ret_ref = learner.update.submit(tuple(batch))
            w_ref = learner.weights.submit()
            pending += [simulate.submit(w_ref, 1000 * it + s)
                        for s in range(16 - len(pending))]
        try:
            returns.append(core.get(ret_ref, timeout=30))
        except core.TaskError:
            pass   # an unreplayable update under --kill-node: skip it
        if it % 5 == 0 or it == iters - 1:
            print(f"iter {it:3d}  mean return {np.mean(returns[-5:]):+.3f}")
        if it % 10 == 9:
            # versioned weight hot-swap handle for external consumers
            w_now = core.get(learner.weights.submit(), timeout=30)
            ps = ParamSet.publish("policy", w_now)
            print(f"iter {it:3d}  published ParamSet policy@v{ps.version}"
                  f" ({ps.total_bytes} bytes)")

    fetch_ok = None
    latest = ParamSet.latest("policy") if w_now is not None else None
    if latest is not None:
        fetched = latest.fetch()
        fetch_ok = all(np.array_equal(np.asarray(w_now[k]), fetched[k])
                       for k in w_now)
        print(f"ParamSet policy@v{latest.version} fetch round-trip: "
              f"{'ok' if fetch_ok else 'MISMATCH'}")

    info = core.get(learner.stats.submit(), timeout=30)
    print(f"learner device: {info['device']} ({info['updates']} updates "
          "on the learner's weights)")
    improved = bool(np.mean(returns[-5:]) > np.mean(returns[:5]))
    mode = "eager" if eager else "compiled"
    print(f"policy improved: {improved} ({len(returns)} {mode} updates "
          "applied)")
    return {"improved": improved, "returns": returns,
            "device": info["device"], "learner_updates": info["updates"],
            "fetch_ok": fetch_ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kill-node", action="store_true")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--eager", action="store_true",
                    help="submit-per-task hot loop (the compiled-graph "
                         "loop is the default)")
    ap.add_argument("--device", default=None,
                    help="the learner's device (default: the card)")
    args = ap.parse_args(argv)
    out = run(args.iters, args.kill_node, args.eager, args.device)
    return 0 if out["improved"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
