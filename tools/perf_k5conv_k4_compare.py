"""K5-conv's, K4's and K10's weight gradient's times on two trees, on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own ``conv.cu`` and ``batch_norm.cu`` and
times, in bf16, on inputs made from one seed:

* K5-conv (``conv2d_act`` with a bias and ReLU) at each conv shape of a
  served forward at batch 32, alone, beside cuDNN's ``F.conv2d`` (with
  the bias); then the forward's 331 convs, each with its own input and
  weight, replayed through both: in one CUDA-event window, as the
  device time of the replay's kernels (``torch.profiler``), and as the
  host's time to launch the replay while a spin kernel holds the device
  (with a ``cProfile`` of the wrappers' own times);
* K4's backward over the 326 BNs of a train step at batch 48 (each with
  its own x and cotangent; the tree's ``_BatchNormTrain.backward``
  called directly), beside ``F.batch_norm(training=True)``'s autograd
  backward: the device time of the replay's kernels (a window would time
  the host's launches of ~1000 small kernels);
* K4's forward over the same 326 BNs (the tree's ``batch_norm_train``
  with running stats), beside ``F.batch_norm(training=True)``: the device
  time of the replay, and each layer's first call alone in a window;
* K10's weight gradient (``_conv2d_wgrad_cuda``, the ResNet's 7x7 /
  stride-2 stem, no bias or mask) at batch 48 and 256^2, beside cuDNN's
  weight gradient (``aten.convolution_backward``), in a window and as
  device time.

``--skip-conv`` leaves out K5-conv.

The timing helpers are this repository's own (``chip_smoke.py``'s
``time_ms`` and ``device_ms``, whose traces are checked for dropped
kernels), whichever tree is timed.

The shapes and their counts come from the tree's own HRNet-W48 (one
forward at batch 1 with the calls recorded). The trees run in the order
given, then in reverse (a b b a), each printing one JSON line.

    python tools/perf_k5conv_k4_compare.py [--skip-conv] TREE [TREE ...]
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
RUN = r"""
import cProfile, collections, importlib.util, json, pstats, sys, time, torch
from pathlib import Path
import torch.nn.functional as F
sys.path.insert(0, ".")
# the timing helpers of this tool's own chip_smoke.py, whatever the tree
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from shapy_tpu_torch.models.backbones import layers
from shapy_tpu_torch.models.backbones.hrnet import HRNet

dev = torch.device("cuda", 0)
cl = torch.channels_last
gen = torch.Generator().manual_seed(0)
for kernel in (layers.CONV_KERNEL, layers.BN_KERNEL):
    kernel.build()

# The shapes and counts of the tree's HRNet (f32 on the CPU, where every
# call runs its plain version): the eval forward's convs, the train
# forward's BNs.
net = HRNet()
convs, bns = collections.Counter(), collections.Counter()
conv_fn, bn_fn = layers.conv2d_act, layers.batch_norm_train

def conv(x, w, b=None, r=None, relu=False, stride=1):
    convs[(x.shape[1], w.shape[0], w.shape[-1], stride, x.shape[2])] += 1
    return conv_fn(x, w, b, r, relu, stride)

def bn(x, *args, **kwargs):
    bns[tuple(x.shape[1:])] += 1
    return bn_fn(x, *args, **kwargs)

layers.conv2d_act, layers.batch_norm_train = conv, bn
x1 = torch.randn(1, 3, 256, 256)
with torch.no_grad():
    net.train()(x1)
    convs.clear()
    layers.fold_bn_(net.eval())
    net(x1)
layers.conv2d_act, layers.batch_norm_train = conv_fn, bn_fn
del net

def rand(shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)

out = {"gpu": cs.gpu_line(), "convs": sum(convs.values()),
       "bns": sum(bns.values()), "conv_cases": []}
if sys.argv[2] == "0":  # K5-conv, unless --skip-conv
    calls = []
    with torch.inference_mode():
        for (cin, cout, k, s, side), n in sorted(convs.items()):
            xs = [rand((32, cin, side, side)).abs() for _ in range(n)]
            ws = [rand((cout, cin, k, k), (cin * k * k) ** -0.5)
                  for _ in range(n)]
            b = torch.randn(cout, generator=gen).to(dev, torch.bfloat16)
            ms = cs.time_ms(lambda: layers.conv2d_act(xs[0], ws[0], b, None,
                                                      True, s))
            lib = cs.time_ms(lambda: F.conv2d(xs[0], ws[0], b, s, k // 2))
            out["conv_cases"].append({"shape": [cin, cout, k, s, side],
                                      "count": n, "ms": ms, "cudnn_ms": lib})
            calls += [(x, w, b, s) for x, w in zip(xs, ws)]
        out["conv_sum_ms"] = sum(c["ms"] * c["count"] for c in out["conv_cases"])
        out["cudnn_sum_ms"] = sum(c["cudnn_ms"] * c["count"]
                                  for c in out["conv_cases"])
        out["conv_replay_ms"] = cs.time_ms(cs.replay(
            lambda x, w, b, s: layers.conv2d_act(x, w, b, None, True, s), calls),
            iters=5, warmup=1)
        out["cudnn_replay_ms"] = cs.time_ms(cs.replay(
            lambda x, w, b, s: F.conv2d(x, w, b, s, w.shape[-1] // 2), calls),
            iters=5, warmup=1)
        out["conv_device_ms"] = cs.device_ms(cs.replay(
            lambda x, w, b, s: layers.conv2d_act(x, w, b, None, True, s), calls))
        out["cudnn_device_ms"] = cs.device_ms(cs.replay(
            lambda x, w, b, s: F.conv2d(x, w, b, s, w.shape[-1] // 2), calls))

        # The host's time to launch the replay, the device held busy by a spin
        # kernel meanwhile (the median of 5), and where it goes in the
        # wrappers (cProfile of one replay: each function's own time).
        def host_ms(fn, reps=5):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                torch.cuda._sleep(int(4e8))
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return sorted(times)[reps // 2]

        kernel = cs.replay(
            lambda x, w, b, s: layers.conv2d_act(x, w, b, None, True, s), calls)
        out["conv_replay_host_ms"] = host_ms(kernel)
        out["cudnn_replay_host_ms"] = host_ms(cs.replay(
            lambda x, w, b, s: F.conv2d(x, w, b, s, w.shape[-1] // 2), calls))
        prof = cProfile.Profile()
        torch.cuda._sleep(int(4e8))
        prof.enable()
        kernel()
        prof.disable()
        torch.cuda.synchronize()
        top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
        out["conv_replay_host_top"] = [
            [f"{Path(f).name}:{line}({name})", v[2] * 1e3, v[0]]
            for (f, line, name), v in top[:12]]
    del calls

class Ctx:  # what _BatchNormTrain.backward reads
    def __init__(self, saved):
        self.saved_tensors = saved

calls, library = [], []
for (c, h, w), n in sorted(bns.items()):
    for _ in range(n):
        x = (rand((48, c, h, w)) * 2 + 0.3).contiguous(memory_format=cl)
        dy = rand((48, c, h, w))
        g = (torch.rand(c, generator=gen) + 0.5).to(dev)
        b = torch.randn(c, generator=gen).to(dev)
        mean, var = layers._moments_plain(x)
        inv = torch.rsqrt(var + 1e-5)
        calls.append((Ctx((x, g, mean, inv)), dy))
        ins = tuple(t.clone().requires_grad_() for t in (x, g, b))
        library.append((F.batch_norm(ins[0], None, None, ins[1], ins[2],
                                     True, 0.1, 1e-5), ins, dy))

def grads(y, ins, dy):
    torch.autograd.grad(y, ins, dy, retain_graph=True)

out["k4_replay_ms"] = cs.device_ms(cs.replay(
    layers._BatchNormTrain.backward, calls))
out["k4_library_ms"] = cs.device_ms(cs.replay(grads, library))
del library

# K4's forward on the same inputs, with running stats.
fwd, fwd_library, firsts = [], [], {}
for ctx, _dy in calls:
    x, g = ctx.saved_tensors[:2]
    b = torch.randn(g.shape[0], generator=gen).to(dev)
    stats = (torch.zeros_like(g), torch.ones_like(g))
    fwd.append((x, g, b, *stats))
    fwd_library.append((x, *stats, g, b))
    firsts.setdefault(tuple(x.shape[1:]), fwd[-1])
with torch.no_grad():
    out["k4_fwd_replay_ms"] = cs.device_ms(cs.replay(
        layers.batch_norm_train, fwd))
    out["k4_fwd_library_ms"] = cs.device_ms(cs.replay(
        lambda x, rm, rv, g, b: F.batch_norm(x, rm, rv, g, b, True, 0.1,
                                             1e-5), fwd_library))
    out["k4_fwd_cases"] = [
        {"shape": [48, *shape], "ms": cs.time_ms(
            lambda: layers.batch_norm_train(*args)),
         "library_ms": cs.time_ms(lambda: F.batch_norm(
             args[0], args[3], args[4], args[1], args[2], True, 0.1, 1e-5))}
        for shape, args in sorted(firsts.items())]
del calls, fwd, fwd_library, firsts

# K10's weight gradient at a ResNet train step's stem.
xs = rand((48, 3, 256, 256))
dys = rand((48, 64, 128, 128))
ws = rand((64, 3, 7, 7))
wgrad = lambda: layers._conv2d_wgrad_cuda(xs, dys, None, ws.shape, 2, False)
cudnn = lambda: torch.ops.aten.convolution_backward(
    dys, xs, ws, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
    [False, True, False])
out["k10_wgrad"] = {"ms": cs.time_ms(wgrad), "device_ms": cs.device_ms(wgrad),
                    "cudnn_ms": cs.time_ms(cudnn),
                    "cudnn_device_ms": cs.device_ms(cudnn)}
print(json.dumps(out))
"""


def main(args) -> int:
    skip_conv = "--skip-conv" in args
    trees = [a for a in args if a != "--skip-conv"]
    if not trees:
        print(__doc__)
        return 2
    order = list(trees) + list(reversed(trees))
    for tree in order:
        proc = subprocess.run([sys.executable, "-c", RUN, str(SMOKE),
                               str(int(skip_conv))],
                              cwd=Path(tree).resolve(), capture_output=True,
                              text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{tree}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
            return 1
        row = json.loads(lines[-1])
        row["tree"] = str(tree)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
