"""Pipeline parallelism: a GPipe schedule over the ``pp`` process group,
the counterpart of ``ray_tpu/parallel/pipeline.py`` (``pipeline_apply``
:65 and ``gpipe_spmd`` :105, one function here).

Each rank of the ``pp`` axis holds one stage's params. Over M + pp - 1
ticks, stage s computes microbatch t - s at tick t: stage 0 reads it from
the input, every other stage receives it from stage s - 1 (``dist.recv``),
and each stage but the last sends its output on (``dist.isend``). Bubble
ticks compute nothing, so a stage's aux values (the MoE load-balancing
loss) sum over its real microbatches only, as the JAX package's mask does
(:161-167). The last stage's outputs are broadcast to every pp rank and
the stages' aux sums are all-reduced, as the JAX package returns a result
replicated over ``pp``.

The backward pass (a ``torch.autograd.Function``) runs the schedule in
reverse: the outputs' gradients are summed onto the last stage (the
broadcast's transpose), each stage back-propagates microbatch by
microbatch through the graph it kept from the forward, receiving its
output's gradient from stage s + 1 and sending its input's gradient to
stage s - 1, and returns its params' gradients. Every rank of the group
issues its sends and receives in the same order, forward and backward.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_mb, meta, *leaves):
        stage_fn, names, group, stage, pp, nxt, prv, last, with_aux = meta
        M = x_mb.shape[0]
        params = {n: p.detach().requires_grad_(p.requires_grad) for n, p in zip(names, leaves)}
        outputs = torch.zeros_like(x_mb)
        aux_sum = torch.zeros((), dtype=torch.float32, device=x_mb.device)
        kept, sends = [], []
        for t in range(M + pp - 1):
            m = t - stage
            if not 0 <= m < M:
                continue  # a bubble tick
            if stage == 0:
                inp = x_mb[m].detach()
            else:
                inp = torch.empty(x_mb.shape[1:], dtype=x_mb.dtype, device=x_mb.device)
                dist.recv(inp, src=prv, group=group)
            inp.requires_grad_(True)
            with torch.enable_grad():
                res = stage_fn(params, inp)
            out, aux = res if with_aux else (res, None)
            if stage < pp - 1:
                sent = out.detach().contiguous()
                sends.append((sent, dist.isend(sent, dst=nxt, group=group)))
            else:
                outputs[m] = out.detach()
            if aux is not None:
                aux_sum += aux.detach().float()
            kept.append((m, inp, out, aux))
        for _, req in sends:
            req.wait()
        dist.broadcast(outputs, src=last, group=group)
        if with_aux:
            dist.all_reduce(aux_sum, group=group)
        ctx.meta, ctx.kept, ctx.params = meta, kept, params
        ctx.x_shape = x_mb.shape
        return outputs, aux_sum

    @staticmethod
    def backward(ctx, d_outputs, d_aux):
        stage_fn, names, group, stage, pp, nxt, prv, last, with_aux = ctx.meta
        d_outputs = d_outputs.contiguous().clone()
        dist.reduce(d_outputs, dst=last, group=group)
        d_aux = d_aux.detach().clone().float()
        if with_aux:
            dist.all_reduce(d_aux, group=group)
        wants = [n for n in names if ctx.params[n].requires_grad]
        grads = {n: None for n in names}
        # zero on the stages that do not read the input, so the graph
        # before the pipeline (the embedding) still reaches every leaf
        dx = torch.zeros(ctx.x_shape, dtype=d_outputs.dtype, device=d_outputs.device)
        sends = []
        for m, inp, out, aux in reversed(ctx.kept):
            if stage == pp - 1:
                g = d_outputs[m]
            else:
                g = torch.empty_like(out)
                dist.recv(g, src=nxt, group=group)
            outs, douts = [out], [g]
            if aux is not None and aux.requires_grad:
                outs.append(aux)
                douts.append(d_aux.to(aux.dtype))
            got = torch.autograd.grad(outs, [inp] + [ctx.params[n] for n in wants], douts,
                                      allow_unused=True)
            d_inp = torch.zeros_like(inp) if got[0] is None else got[0]
            if stage > 0:
                d_inp = d_inp.contiguous()
                sends.append((d_inp, dist.isend(d_inp, dst=prv, group=group)))
            else:
                dx[m] = d_inp
            for n, gp in zip(wants, got[1:]):
                if gp is not None:
                    grads[n] = gp if grads[n] is None else grads[n] + gp
        for _, req in sends:
            req.wait()
        ctx.kept = ctx.params = None
        return (dx, None) + tuple(grads[n] for n in names)


def pipeline_apply(stage_params: dict, x_mb: torch.Tensor, stage_fn: Callable, mesh, *,
                   axis_name: str = "pp", with_aux: bool = False):
    """Run a GPipe pipeline over the ``axis_name`` axis.

    stage_params: this rank's stage's params, a dict of tensors (the
    rank's shard of the JAX function's [pp, ...] leaves). x_mb: [M, mb,
    ...] microbatches, on every rank of the axis (stage 0 reads them).
    stage_fn: (params, activation [mb, ...]) -> activation of the same
    shape, or (activation, aux scalar) when ``with_aux``.
    Returns the [M, mb, ...] outputs on every rank of the axis, and with
    ``with_aux`` also the sum of aux over every stage and real microbatch."""
    from ray_tpu_torch.parallel.mesh import axis_group, mesh_sizes, peer_rank

    pp = mesh_sizes(mesh)[axis_name]
    if pp == 1:
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x_mb.device)
        for m in range(x_mb.shape[0]):
            res = stage_fn(stage_params, x_mb[m])
            out, a = res if with_aux else (res, None)
            outs.append(out)
            if a is not None:
                aux = aux + a.float()
        out = torch.stack(outs)
        return (out, aux) if with_aux else out
    stage = mesh.get_local_rank(axis_name)
    names = list(stage_params)
    meta = (stage_fn, names, axis_group(mesh, axis_name), stage, pp,
            peer_rank(mesh, axis_name, min(stage + 1, pp - 1)),
            peer_rank(mesh, axis_name, max(stage - 1, 0)),
            peer_rank(mesh, axis_name, pp - 1), with_aux)
    out, aux = _GPipe.apply(x_mb, meta, *[stage_params[n] for n in names])
    return (out, aux) if with_aux else out
