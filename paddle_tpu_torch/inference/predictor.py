"""AnalysisPredictor equivalent: load once, serve many.

Counterpart of `paddle_tpu/inference/predictor.py`.  The reference
jit-compiles the loaded program into one XLA executable per feed
signature; the port runs the program's ops eagerly on the card (or the
CPU when asked), over weights loaded once onto the device.  Each
``matmul_bias_act`` op whose weight is a loaded constant reads a copy
of it transposed once at load to the ``[N, K]`` layout kernel 5 takes
(``<name>@NK``), so no request copies a weight.

``compile_count`` counts distinct feed signatures (PyTorch compiles
nothing; the generation engine's ``stats()["executables"]`` counts the
same way).  ``cost_analysis`` counts the model FLOPs of one run through
`observability.cost.FlopCounter`.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..fluid import framework, io
from ..fluid.core import dtypes as dtypes_mod
from ..fluid.core.block_eval import run_ops
from ..fluid.core.place import place_of
from ..fluid.core.registry import LowerContext
from ..fluid.core.scope import Scope
from ..fluid.executor import Executor, scope_guard, to_numpy, to_tensor

NK_SUFFIX = "@NK"


class AnalysisConfig:
    """cf. reference AnalysisConfig: model path and device.  The device is
    the card unless `disable_gpu` (or a ``device=`` given to
    `create_predictor`) says otherwise."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._device = None
        self._memory_optim = True

    def enable_use_gpu(self, memory_pool_mb=100, device_id=0):
        self._device = torch.device("cuda", device_id)

    def disable_gpu(self):
        self._device = torch.device("cpu")

    def switch_ir_optim(self, flag=True):
        self._memory_optim = flag  # recorded, as the reference does

    def enable_memory_optim(self):
        self._memory_optim = True

    def enable_compilation_cache(self, cache_dir=None):
        """Accepted for parity: PyTorch compiles no executables, and the
        hand kernels are built once into ``build/kernels``."""

    def enable_int8(self):
        raise NotImplementedError(
            "enable_int8 (weight-only int8 through "
            "contrib.slim.quantization) waits for a later slice of the "
            "static core (ROADMAP Queue A 3)")


class Predictor:
    """Load-once server runner (cf. AnalysisPredictor + NaiveExecutor).

    ``device``: where the weights live and the ops run; None takes the
    config's (`AnalysisConfig.disable_gpu` / `enable_use_gpu`), else the
    card."""

    def __init__(self, config: AnalysisConfig, device=None):
        self._config = config
        self.device = resolve_device(device if device is not None
                                     else config._device)
        self._scope = Scope()
        exe = Executor(place_of(self.device))
        with scope_guard(self._scope):
            program, feeds, fetches = io.load_inference_model(
                config.model_dir, exe,
                model_filename=config.prog_file,
                params_filename=config.params_file,
            )
        self._program = program
        self._feed_names = list(feeds)
        self._fetch_names = [
            f.name if hasattr(f, "name") else f for f in fetches
        ]
        self._feed_dtypes = {
            n: program.global_block.var(n).dtype for n in self._feed_names}
        self._plan_version = None
        self._ops = self._weights = None
        self._read = []      # (scope name, the tensor the plan read)
        self._signatures = set()
        self._costs = {}     # feed signature -> cost_analysis dict

    # -- the run plan --------------------------------------------------
    def _plan(self):
        """(ops, weights) for the program and scope as they stand:
        rebuilt when a pass (``fluid.ir.apply_passes(predictor._program,
        ...)``, as with the reference's predictor) has changed the
        program, or a scope value the plan read has been replaced
        (``io.load_persistables`` into ``predictor._scope``), since the
        last run.  The weights are the loaded values the ops read; a
        ``matmul_bias_act`` whose Y is a loaded 2-D weight reads
        ``Y@NK``, that weight transposed once to ``[N, K]``.  The scope
        then keeps Y as a ``[K, N]`` view of that copy, so the card
        holds each weight once."""
        program = self._program
        if self._plan_version == program._version and all(
                self._scope.find_var(n) is t for n, t in self._read):
            return self._ops, self._weights
        block = program.global_block
        ops, weights = [], {}
        for op in block.ops:
            w_name = op.inputs.get("Y", [None])[0]
            w = self._scope.find_var(w_name) if w_name else None
            if (op.type == "matmul_bias_act" and w is not None
                    and w.dim() == 2 and op.attrs.get(
                        "y_num_col_dims", 1) == 1):
                if op.attrs.get("transpose_Y",
                                op.attrs.get("transpose_y", False)):
                    nk = w_name                  # already [N, K]
                else:
                    nk = w_name + NK_SUFFIX
                    if nk not in weights:
                        weights[nk] = w.t().contiguous()
                        self._scope.set(w_name, weights[nk].t())
                op = framework.Operator(
                    block, op.type, dict(op.inputs, Y=[nk]), op.outputs,
                    dict(op.attrs, weight_layout="NK"))
            ops.append(op)
        read = {}
        for op in ops:
            for name in op.all_input_names():
                if name not in weights and self._scope.has(name):
                    weights[name] = self._scope.find_var(name)
        for name in {n for op in block.ops for n in op.all_input_names()}:
            if self._scope.has(name):
                read[name] = self._scope.find_var(name)
        self._ops, self._weights = ops, weights
        self._read = list(read.items())
        self._plan_version = program._version
        return ops, weights

    # -- reference-style API -------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def _prepare_feed(self, inputs):
        """Validate + normalize inputs into {name: tensor on the device,
        in the feed's declared dtype}.  A list must match feed
        order/length exactly; a dict must carry exactly the declared
        feeds."""
        if isinstance(inputs, dict):
            unknown = sorted(set(inputs) - set(self._feed_names))
            missing = sorted(set(self._feed_names) - set(inputs))
            if unknown or missing:
                raise ValueError(
                    "feed dict mismatch: expects feeds %s%s%s"
                    % (self._feed_names,
                       ("; missing %s" % missing) if missing else "",
                       ("; unknown %s" % unknown) if unknown else ""))
            items = inputs.items()
        else:
            inputs = list(inputs)
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    "feed list length mismatch: expects %d feeds %s, got %d"
                    % (len(self._feed_names), self._feed_names, len(inputs)))
            items = zip(self._feed_names, inputs)
        return {n: to_tensor(v, self._feed_dtypes[n], self.device)
                for n, v in items}

    @staticmethod
    def _signature(feed_vals):
        return tuple((k, tuple(v.shape), dtypes_mod.to_str(v.dtype))
                     for k, v in sorted(feed_vals.items()))

    @property
    def compile_count(self):
        """Distinct feed signatures this predictor has run: the
        counterpart of the reference's executable count (one XLA
        executable per signature), the serving path's shape-storm
        gauge."""
        return len(self._signatures)

    def _run(self, feed_vals):
        ops, weights = self._plan()
        self._signatures.add(self._signature(feed_vals))
        env = dict(weights)
        env.update(feed_vals)
        ctx = LowerContext(is_test=True, device=self.device)
        with torch.no_grad():     # inference_mode hides ops from FlopCounter
            run_ops(ops, env, ctx)
        return [env[n] for n in self._fetch_names]

    def run(self, inputs):
        """inputs: list of arrays (feed order) or {name: array}; numpy
        arrays or tensors.  Returns a list of numpy arrays in fetch
        order."""
        return [to_numpy(o) for o in self._run(self._prepare_feed(inputs))]

    def run_async(self, inputs):
        """Like run() but returns the output tensors on the device
        without waiting for them: the kernels are queued on the current
        CUDA stream, so the caller can overlap host work with the card's.
        Reading a value (``.cpu()``, ``.item()``) waits for it."""
        return self._run(self._prepare_feed(inputs))

    def cost_analysis(self, inputs):
        """``{"flops": n}``: the model FLOPs of one run at this feed
        signature, counted by `observability.cost.FlopCounter` (the
        matmul-class aten ops by torch's formulas, each hand kernel's
        wrapper its own work; elementwise work is not counted).  Cached
        per signature."""
        from ..observability.cost import FlopCounter

        feed_vals = self._prepare_feed(inputs)
        sig = self._signature(feed_vals)
        if sig not in self._costs:
            with FlopCounter() as counter:
                self._run(feed_vals)
            self._costs[sig] = {"flops": counter.flops}
        return dict(self._costs[sig])

    def warmup(self, bucket_specs):
        """Run each feed signature of ``bucket_specs`` once before
        traffic arrives (builds the kernels on their first launch).

        bucket_specs: iterable of {feed_name: spec} dicts where spec is a
        shape tuple (the feed's declared dtype), a (shape, dtype) pair,
        or a ready-made array.  Returns the resulting compile_count."""
        import numpy as np

        for spec in bucket_specs:
            feed = {}
            for name, s in spec.items():
                if isinstance(s, (np.ndarray, torch.Tensor)):
                    feed[name] = s
                elif (isinstance(s, (tuple, list)) and len(s) == 2
                        and not isinstance(s[1], (int, np.integer))):
                    feed[name] = np.zeros(tuple(s[0]), np.dtype(s[1]))
                else:
                    feed[name] = np.zeros(
                        tuple(s), np.dtype(self._feed_dtypes[name]))
            self.run_async(feed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_count


def create_predictor(config: AnalysisConfig, device=None) -> Predictor:
    """cf. reference CreatePaddlePredictor / create_predictor."""
    return Predictor(config, device=device)


def export_stablehlo(dirname, predictor, example_inputs):
    raise NotImplementedError(
        "export_stablehlo has no PyTorch counterpart yet; a portable "
        "export of the static program waits for a later slice (ROADMAP "
        "Queue A 3)")


def load_stablehlo(dirname):
    raise NotImplementedError(
        "load_stablehlo has no PyTorch counterpart yet; a portable "
        "export of the static program waits for a later slice (ROADMAP "
        "Queue A 3)")
