"""Solvers: the line-search and second-order optimizers (JAX counterpart
deeplearning4j_tpu/optimize/solvers.py; reference Solver.java:48,55,
solvers/BaseOptimizer.java, StochasticGradientDescent.java,
BackTrackLineSearch.java, ConjugateGradient.java, LBFGS.java,
LineGradientDescent.java, StochasticHessianFree.java, stepfunctions/*,
terminations/*).

Each solver works over one flat parameter vector (nn/tree.flatten: the
leaves in the JAX package's order, keys sorted at every level; f32, or
f64 for an f64 net) on the net's device. `loss_f(x, *args)` is a scalar
tensor function; gradients come from autograd, and the backtracking
line search is a host loop of loss evaluations. As in the JAX package,
the updater (Adam, momentum) is not applied inside these solvers: SGD
is the path that composes with updaters (nn/training.py).

HessianFree's curvature-vector products are double backward passes
through the loss. A hand-written kernel has no second derivative (nor
has the JAX package's custom VJP of it), so on a network whose forward
takes a kernel route HessianFree raises `SecondDerivativeError`
(ops/__init__.py) instead of falling back to the plain version.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


class LocalSpace:
    """The flat parameter space of a net on no mesh: this process's own
    loss, gradient and inner products (`MeshSpace` is a placed net's)."""

    groups = ()

    def shard(self, generator):
        """(the shard context of a loss evaluation, its generator)."""
        return contextlib.nullcontext(), generator

    def mean(self, t):
        return t

    def dot(self, a, b):
        return _vdot(a, b)

    def amax(self, t):
        return t.abs().max()


LOCAL = LocalSpace()


# --------------------------------------------------------------------------
# Step functions (reference optimize/stepfunctions/*)
# --------------------------------------------------------------------------
class StepFunction:
    """step(params, direction, step_size) -> new params."""

    sign = 1.0

    def step(self, params, direction, step):
        return params + self.sign * step * direction


class DefaultStepFunction(StepFunction):
    sign = 1.0


class NegativeDefaultStepFunction(StepFunction):
    """The SGD default (reference NegativeDefaultStepFunction): params -=
    update."""

    sign = -1.0


class GradientStepFunction(StepFunction):
    sign = 1.0


class NegativeGradientStepFunction(StepFunction):
    sign = -1.0


STEP_FUNCTIONS = {
    "default": DefaultStepFunction,
    "negative_default": NegativeDefaultStepFunction,
    "gradient": GradientStepFunction,
    "negative_gradient": NegativeGradientStepFunction,
}


# --------------------------------------------------------------------------
# Termination conditions (reference optimize/terminations/*)
# --------------------------------------------------------------------------
class TerminationCondition:
    """terminate(new_score, old_score, direction, space): `space` is the
    solver's flat space (`LOCAL`, or a placed net's `MeshSpace`), whose
    `dot` and `amax` take in the whole direction where each rank holds a
    part of it."""

    def terminate(self, new_score, old_score, direction, space) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """|new - old| < eps*|old| + tol (reference EpsTermination)."""

    def __init__(self, eps: float = 1e-4, tol: float = 1e-8):
        self.eps, self.tol = eps, tol

    def terminate(self, new_score, old_score, direction, space):
        return abs(new_score - old_score) < self.eps * abs(old_score) + self.tol


class Norm2Termination(TerminationCondition):
    """||direction||_2 < tolerance (reference Norm2Termination)."""

    def __init__(self, gradient_tolerance: float = 1e-6):
        self.tol = gradient_tolerance

    def terminate(self, new_score, old_score, direction, space):
        return float(space.dot(direction, direction)) ** 0.5 < self.tol


class ZeroDirection(TerminationCondition):
    def terminate(self, new_score, old_score, direction, space):
        return float(space.amax(direction)) == 0.0


DEFAULT_TERMINATIONS = (ZeroDirection(), EpsTermination())


# --------------------------------------------------------------------------
# Backtracking line search (reference solvers/BackTrackLineSearch.java)
# --------------------------------------------------------------------------
@torch.no_grad()
def backtrack_line_search(loss_f, x, f0, g, direction, *, initial_step=1.0,
                          rho=0.5, c1=1e-4, max_iters=16, min_step=1e-10,
                          dot=_vdot):
    """Armijo backtracking: from t = initial_step, halve t (rho) up to
    max_iters times until f(x + t*d) <= f0 + c1*t*<g, d>. Returns
    (t, f(x + t*d)) as floats, or (0.0, f0) if no decrease was found."""
    slope = float(dot(g, direction))
    f0 = float(f0)
    t = float(initial_step)
    ft = float(loss_f(x + t * direction))
    it = 0
    while it < max_iters and t > min_step and ft > f0 + c1 * t * slope:
        t *= rho
        ft = float(loss_f(x + t * direction))
        it += 1
    if ft <= f0 + c1 * t * slope:
        return t, ft
    return 0.0, f0


@dataclass
class SolveResult:
    x: torch.Tensor
    score: float
    iterations: int
    converged: bool


# --------------------------------------------------------------------------
# Base optimizer: a host loop of value-and-grad and line-searched steps
# --------------------------------------------------------------------------
class BaseOptimizer:
    """Shared machinery (reference solvers/BaseOptimizer.java).

    loss_f(x, *args) -> scalar tensor; `*args` (minibatch, layer state,
    ...) pass through every evaluation. Subclasses define `direction`
    and the curvature updates. `space` (`LOCAL`, or the `MeshSpace` that
    `Solver` sets for a net on a mesh) means every loss, gradient and
    curvature product over the batch's shards and gives the inner
    product of the flat space."""

    space = LOCAL

    def __init__(self, loss_f: Callable, max_iterations: int = 10,
                 step_function: Optional[StepFunction] = None,
                 terminations: Sequence[TerminationCondition] = DEFAULT_TERMINATIONS,
                 listeners=(), initial_step: float = 1.0,
                 max_line_search_iterations: int = 16):
        self.loss_f = loss_f
        self.max_iterations = max_iterations
        self.step_function = step_function or NegativeDefaultStepFunction()
        self.terminations = list(terminations)
        self.listeners = list(listeners)
        self.initial_step = initial_step
        self.max_line_search_iterations = max_line_search_iterations
        self.score_value = float("nan")

    def dot(self, a, b):
        return self.space.dot(a, b)

    def _mean(self, t):
        return self.space.mean(t)

    def vg(self, x, *args):
        """(loss, gradient) at x, both detached."""
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            f = self.loss_f(x, *args)
            (g,) = torch.autograd.grad(f, x)
        return self._mean(f.detach()), self._mean(g)

    def _line_step(self, x, f0, g, direction, *args):
        # search along sign*direction; if that is not a descent direction
        # (<g, d> >= 0) restart with steepest descent (reference
        # BackTrackLineSearch slope check)
        d = self.step_function.sign * direction
        if not float(self.dot(g, d)) < 0:
            d = -g
        t, ft = backtrack_line_search(
            lambda z: self._mean(self.loss_f(z, *args)), x, f0, g, d,
            initial_step=self.initial_step,
            max_iters=self.max_line_search_iterations, dot=self.dot)
        return x + t * d, ft, t

    # subclass API ---------------------------------------------------------
    def init_aux(self, x, g):
        return None

    def direction(self, x, g, aux):
        """(a direction pointing downhill when negated, new aux)."""
        return g, aux

    def update_aux(self, aux, x_old, x_new, g_old, g_new, d_used):
        return aux

    # main loop (reference BaseOptimizer.optimize:191) ----------------------
    def optimize(self, x0, *args) -> SolveResult:
        x = torch.as_tensor(x0).detach()
        f, g = self.vg(x, *args)
        aux = self.init_aux(x, g)
        old_f = float("inf")
        converged = False
        i = 0
        for i in range(1, self.max_iterations + 1):
            d, aux = self.direction(x, g, aux)
            x_new, f_new, t = self._line_step(x, f, g, d, *args)
            if t == 0.0:  # no decrease along d: give up (ref: step == 0)
                converged = True
                break
            _, g_new = self.vg(x_new, *args)
            self._f_pair = (float(f), f_new)
            aux = self.update_aux(aux, x, x_new, g, g_new, d)
            x, old_f, f, g = x_new, float(f), f_new, g_new
            self.score_value = f_new
            for lst in self.listeners:
                lst.iteration_done(self, i)
            if any(tc.terminate(f_new, old_f, d, self.space)
                   for tc in self.terminations):
                converged = True
                break
        return SolveResult(x, float(f), i, converged)


class LineGradientDescent(BaseOptimizer):
    """Steepest descent with a line search (reference
    LineGradientDescent.java)."""


class ConjugateGradient(BaseOptimizer):
    """Polak-Ribiere nonlinear CG with restarts (PR+; reference
    solvers/ConjugateGradient.java)."""

    def init_aux(self, x, g):
        return {"d_prev": torch.zeros_like(g), "g_prev": torch.zeros_like(g),
                "first": True}

    def direction(self, x, g, aux):
        if aux["first"]:
            return g, dict(aux, first=False)
        g_prev, d_prev = aux["g_prev"], aux["d_prev"]
        beta = (self.dot(g, g - g_prev)
                / self.dot(g_prev, g_prev).clamp_min(1e-30)).clamp_min(0.0)
        return g + beta * d_prev, aux

    def update_aux(self, aux, x_old, x_new, g_old, g_new, d_used):
        return {"d_prev": d_used, "g_prev": g_old, "first": False}


class LBFGS(BaseOptimizer):
    """L-BFGS two-loop recursion over the newest m curvature pairs
    (reference solvers/LBFGS.java)."""

    def __init__(self, loss_f, max_iterations: int = 10, m: int = 10, **kw):
        super().__init__(loss_f, max_iterations, **kw)
        self.m = m

    def init_aux(self, x, g):
        return {"pairs": []}  # [(s, y, 1 / s'y)], oldest first

    def direction(self, x, g, aux):
        """H*g by the two-loop recursion (an ascent direction scaled by
        the curvature), the newest pair's s'y / y'y as the initial
        scale."""
        pairs = aux["pairs"]
        q = g
        alphas = []
        for s, y, rho in reversed(pairs):
            a = rho * self.dot(s, q)
            q = q - a * y
            alphas.append(a)
        if pairs:
            s, y, _ = pairs[-1]
            q = q * (self.dot(s, y) / self.dot(y, y).clamp_min(1e-30))
        for (s, y, rho), a in zip(pairs, reversed(alphas)):
            b = rho * self.dot(y, q)
            q = q + (a - b) * s
        return q, aux

    def update_aux(self, aux, x_old, x_new, g_old, g_new, d_used):
        s = x_new - x_old
        y = g_new - g_old
        sy = float(self.dot(s, y))
        if sy <= 1e-10:  # the curvature condition fails: skip the pair
            return aux
        pairs = (aux["pairs"] + [(s, y, 1.0 / sy)])[-self.m:]
        return {"pairs": pairs}


class StochasticGradientDescent(BaseOptimizer):
    """Plain SGD steps at a fixed learning rate (reference
    StochasticGradientDescent.java:53-75); networks normally take the
    SGD-family train step (nn/training.py), this is the Solver API's."""

    def __init__(self, loss_f, max_iterations=10, lr=0.1, **kw):
        super().__init__(loss_f, max_iterations, **kw)
        self.lr = lr

    def optimize(self, x0, *args):
        x = torch.as_tensor(x0).detach()
        f = float("nan")
        for i in range(1, self.max_iterations + 1):
            fv, g = self.vg(x, *args)
            x = x - self.lr * g
            f = float(fv)
            self.score_value = f
            for lst in self.listeners:
                lst.iteration_done(self, i)
        return SolveResult(x, f, self.max_iterations, True)


class HessianFree(BaseOptimizer):
    """Hessian-free (truncated Newton) optimization (reference
    OptimizationAlgorithm.HESSIAN_FREE / StochasticHessianFree.java):
    each outer iteration runs damped conjugate gradient on
    (H + lam*I) d = g, with H*v a double backward pass through the loss,
    and line-searches along -d; lam adapts Levenberg-Marquardt style from
    the reduction ratio (Martens 2010)."""

    def __init__(self, loss_f, max_iterations=10, cg_iterations=32,
                 initial_lambda=1.0, **kw):
        super().__init__(loss_f, max_iterations, **kw)
        self.cg_iterations = cg_iterations
        self.lam = float(initial_lambda)
        self._args = ()

    def hvp(self, x, v, *args):
        """The Hessian of the loss at x times v. Raises
        SecondDerivativeError where the loss runs a kernel."""
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self.loss_f(x, *args), x,
                                       create_graph=True)
            (hv,) = torch.autograd.grad(g, x, v)
        return self._mean(hv)

    def _cg_solve(self, x, g, lam, *args):
        d = torch.zeros_like(g)
        r = g  # the residual of A d = g at d = 0
        p = r
        rs = self.dot(r, r)
        for _ in range(self.cg_iterations):
            Ap = self.hvp(x, p, *args) + lam * p
            denom = self.dot(p, Ap)
            alpha = torch.where(denom > 1e-20, rs / denom,
                                torch.zeros_like(rs))
            d = d + alpha * p
            r = r - alpha * Ap
            rs_new = self.dot(r, r)
            beta = torch.where(rs > 1e-20, rs_new / rs, torch.zeros_like(rs))
            p = r + beta * p
            rs = rs_new
        return d

    def direction(self, x, g, aux):
        d = self._cg_solve(x, g, self.lam, *self._args)
        # the gradient where CG gives no descent direction
        if not (bool(torch.isfinite(d).all()) and float(self.dot(g, d)) > 0):
            d = g
        return d, aux

    def update_aux(self, aux, x_old, x_new, g_old, g_new, d_used):
        delta = x_new - x_old
        Hd = self.hvp(x_old, delta, *self._args)
        model_change = float(self.dot(g_old, delta) + 0.5 * self.dot(delta, Hd))
        f_old, f_new = self._f_pair
        if model_change < 0:
            rho = (f_new - f_old) / model_change
            if rho > 0.75:
                self.lam *= 2.0 / 3.0
            elif rho < 0.25:
                self.lam *= 1.5
        return aux

    def optimize(self, x0, *args):
        self._args = args
        return super().optimize(x0, *args)


_OPTIMIZERS = {
    OptimizationAlgorithm.HESSIAN_FREE: HessianFree,
    OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT: StochasticGradientDescent,
    OptimizationAlgorithm.LINE_GRADIENT_DESCENT: LineGradientDescent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
    OptimizationAlgorithm.LBFGS: LBFGS,
}


def _replay(state, device):
    """A generator at `state` (the same draws every evaluation: the JAX
    package holds one rng key fixed through a solve), or None."""
    if state is None:
        return None
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class MeshSpace:
    """The flat parameter space of a net on a mesh (parallel/placement.py
    `set_mesh`), where each rank solves over its own params (`tree.
    flatten`: a split leaf's slice on each rank of its axis) and its own
    part of the batch (its rows along "data", its block along "seq"):

    - `shard(generator)`: the shard a loss evaluation runs as, the
      train steps' own (`DataShard`, or the `SeqShard` with its ring)
      and the generator its other draws take;
    - `mean(t)`: a loss, gradient or curvature product averaged over the
      data and seq shards (each shard's loss is a mean over equally many
      examples), so every rank holds the same one;
    - `dot(a, b)`: the inner product of the whole space, a split leaf's
      share summed over its axis and a whole leaf counted once;
    - `amax(t)`: the largest |entry| of the whole space.

    Every scalar a solver decides on is then the same on every rank, and
    the solve is the meshless one on the global batch with the params
    left placed as they are."""

    def __init__(self, net):
        from deeplearning4j_tpu_torch.parallel.placement import mesh_axis

        mesh = net._mesh
        self.mesh = mesh
        self.data_axis = mesh_axis(net, "data")
        self.seq_axis = mesh_axis(net, "seq")
        self.axes = [a for a in (self.data_axis, self.seq_axis) if a]
        self.groups = [(mesh.group(a), mesh.axis_size(a))
                       for a in self.axes if mesh.axis_size(a) > 1]
        self.size = 1
        for a in self.axes:
            self.size *= mesh.axis_size(a)
        self.split = []  # [(process group, flat positions it splits)]
        plan = getattr(net, "_split_plan", None)
        if plan is not None and plan.leaves:
            by_axis, off = {}, 0
            for path, t in tree.leaves(net.params):
                n = t.numel()
                leaf = plan.leaves.get(path)
                if leaf is not None:
                    by_axis.setdefault(leaf[0], []).append(
                        torch.arange(off, off + n))
                off += n
            mine = torch.zeros(off, dtype=torch.bool)
            for axis in sorted(by_axis):
                idx = torch.cat(by_axis[axis])
                mine[idx] = True
                self.split.append((mesh.group(axis),
                                   idx.to(mesh.device)))
            self.whole = (~mine).nonzero()[:, 0].to(mesh.device)

    def shard(self, generator):
        """(the shard context of a loss evaluation, its generator)."""
        from deeplearning4j_tpu_torch.ops.shard_scope import (
            DataShard,
            SeqShard,
            shard_generator,
            sharded,
        )
        from deeplearning4j_tpu_torch.parallel.ring_attention import (
            ProcessGroupRing,
        )

        mesh = self.mesh
        if self.seq_axis is not None:
            idx = tuple(mesh.axis_index(a) for a in self.axes)
            n = mesh.axis_size(self.seq_axis)
            ring = ProcessGroupRing(mesh.group(self.seq_axis), n,
                                    mesh.axis_index(self.seq_axis))
            seq = SeqShard(self.seq_axis, ring,
                           mesh.axis_index(self.seq_axis), n,
                           shard_generator(generator, idx[:-1], self.size))
            return (sharded(seq=seq),
                    shard_generator(generator, idx, self.size))
        if self.data_axis is not None:
            return sharded(data=DataShard(
                mesh.group(self.data_axis), mesh.axis_size(self.data_axis),
                mesh.axis_index(self.data_axis))), generator
        return sharded(), generator

    def mean(self, t):
        if not self.groups:
            return t
        from deeplearning4j_tpu_torch.parallel.overlap import (
            reduce_gradients,
        )

        return reduce_gradients({"t": t}, self.groups)["t"]

    def amax(self, t):
        """max |t| over the whole space: each split leaf's share reduced
        with MAX over its axis (a whole leaf is the same on every rank)."""
        m = t.abs().max()
        if self.split:
            import torch.distributed as dist

            for group, _ in self.split:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        return m

    def dot(self, a, b):
        if not self.split:
            return _vdot(a, b)
        import torch.distributed as dist

        ab = a.reshape(-1) * b.reshape(-1)
        total = ab[self.whole].sum()
        for group, idx in self.split:
            part = ab[idx].sum()
            dist.all_reduce(part, group=group)
            total = total + part
        return total


class Solver:
    """Optimizes a network's parameters on one batch with the configured
    algorithm (reference Solver.Builder().model(m).build()):

        Solver(model).optimize(batch_dict, generator)  # sets model.params

    Listeners given here get the optimizer once per line-searched
    iteration; the network's listeners are fired by the container once
    per minibatch. On a mesh (`set_mesh`; not "pipe", whose placement
    refuses the solvers as the JAX package's does) `batch_dict` holds
    this rank's part of the batch and the solve runs over the mesh
    (`MeshSpace`): the meshless solve on the global batch, the params
    left placed as they were."""

    def __init__(self, model, algorithm: Optional[str] = None,
                 max_iterations: Optional[int] = None, listeners=()):
        self.model = model
        g = model.conf.conf
        self.algorithm = str(algorithm or g.optimization_algo)
        self.max_iterations = max_iterations or max(1, g.iterations)
        self.listeners = list(listeners)
        self._opt = None

    def get_optimizer(self, loss_f) -> BaseOptimizer:
        g = self.model.conf.conf
        cls = _OPTIMIZERS[OptimizationAlgorithm(self.algorithm)]
        kw = {}
        if cls is StochasticGradientDescent:
            kw["lr"] = g.learning_rate
        else:
            kw["max_line_search_iterations"] = max(
                1, g.max_num_line_search_iterations)
        return cls(loss_f, max_iterations=self.max_iterations,
                   listeners=self.listeners, **kw)

    def _space(self):
        mesh = getattr(self.model, "_mesh", None)
        return LOCAL if mesh is None else MeshSpace(self.model)

    def _optimizer(self):
        """One optimizer for the whole fit (HessianFree's damping carries
        from batch to batch)."""
        if self._opt is None:
            m = self.model
            space = self._space()

            def loss_f(x, like, state, gen_state, batch):
                ctx, gen = space.shard(_replay(gen_state, m.device))
                with ctx:
                    loss, _ = m._loss(tree.unflatten(x, like), state, gen,
                                      batch, train=True)
                return loss

            self._opt = self.get_optimizer(loss_f)
            self._opt.space = space
        return self._opt

    def optimize(self, batch, generator=None):
        m = self.model
        gen_state = None if generator is None else generator.get_state()
        opt = self._optimizer()
        res = opt.optimize(tree.flatten(m.params), m.params, m.state,
                           gen_state, batch)
        m.params = tree.unflatten(res.x, m.params)
        # one forward at the solution refreshes the layer state (batch
        # norm's running statistics), which the flat loss discards
        space = opt.space
        with torch.no_grad():
            ctx, gen = space.shard(generator)
            with ctx:
                _, (new_state, _) = m._loss(m.params, m.state, gen, batch,
                                            train=True)
        for group, n in space.groups:
            from deeplearning4j_tpu_torch.parallel.overlap import (
                pmean_float_leaves,
            )

            new_state = pmean_float_leaves(new_state, group, n)
        m.state = new_state
        m.score_value = res.score
        m.iteration_count += res.iterations
        return res
