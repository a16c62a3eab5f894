"""Saving and loading variables and inference models.

Counterpart of `paddle_tpu/fluid/io.py`, in the same on-disk format:
``__model__.json`` (the JSON IR of `framework.Program`), ``__meta__.pkl``
(feed and fetch names) and one ``<name>.npy`` per persistable (or one
``.npz`` when a ``filename`` is given).  A directory written by either
package loads in the other.  Values go through the scope as torch
tensors, loaded onto the executor's device.
"""

import os
import pickle

import numpy as np
import torch

from . import framework
from .core.scope import global_scope
from .executor import to_numpy


def _collect_vars(program, predicate):
    return [v for v in program.list_vars() if predicate(v)]


def _is_persistable(v):
    return v.persistable and not v.is_data


def _is_param(v):
    return isinstance(v, framework.Parameter)


def _var_file(dirname, name):
    return os.path.join(dirname, name.replace("/", "__slash__"))


def _save_var_dict(dirname, var_values, filename=None):
    os.makedirs(dirname, exist_ok=True)
    if filename:
        np.savez(os.path.join(dirname, filename), **var_values)
    else:
        for name, val in var_values.items():
            np.save(_var_file(dirname, name), val)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    program = main_program or framework.default_main_program()
    if vars is None:
        vars = _collect_vars(program, predicate or _is_persistable)
    scope = global_scope()
    values = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError("variable %s has no value in scope" % v.name)
        values[v.name] = to_numpy(val) if isinstance(val, torch.Tensor) \
            else np.asarray(val)
    _save_var_dict(dirname, values, filename)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_param, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Load saved values into the global scope, as tensors on
    ``executor``'s device."""
    program = main_program or framework.default_main_program()
    if vars is None:
        vars = _collect_vars(program, predicate or _is_persistable)
    scope = global_scope()
    if filename:
        data = np.load(os.path.join(dirname, filename), allow_pickle=False)
        get = lambda name: data[name]  # noqa: E731
    else:
        def get(name):
            return np.load(_var_file(dirname, name) + ".npy")

    for v in vars:
        scope.set(v.name, torch.from_numpy(np.ascontiguousarray(
            get(v.name))).to(executor.device))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_param, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


# ---------------------------------------------------------------------------
# graph pruning for inference export
# ---------------------------------------------------------------------------

def _prune_program(program, feed_names, target_names):
    """Keep only ops backward-reachable from targets, stopping at feeds
    (cf. reference Program._prune_with_input used by save_inference_model)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block
    needed = set(target_names)
    keep = []
    for op in reversed(block.ops):
        outs = op.all_output_names()
        if any(n in needed for n in outs):
            keep.append(op)
            for n in op.all_input_names():
                if n not in feed_names:
                    needed.add(n)
    keep.reverse()
    block.ops = keep
    # drop vars not referenced anymore (keep feeds + referenced)
    referenced = set(feed_names) | set(target_names)
    for op in keep:
        referenced.update(op.all_input_names())
        referenced.update(op.all_output_names())
    block.vars = {k: v for k, v in block.vars.items() if k in referenced}
    for name in feed_names:
        if name in block.vars:
            block.vars[name].is_data = True
    pruned._bump()
    return pruned


def _verify_io_program(program, feed_names, fetch_names, what):
    """Static verification gate on the export/load paths (the
    reference's FLAGS_verify_io_programs, on by default; the port has no
    flag to turn it off): a pruned-wrong or corrupted serialized program
    fails HERE with structured diagnostics.  Structural invariants only,
    op types included, so a program with an op the port lacks fails at
    load with ``unknown-op``."""
    from ..analysis import assert_program_valid

    assert_program_valid(program, feed_names=feed_names,
                         fetch_names=fetch_names, check_shapes=False,
                         what=what)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """cf. reference io.py:1093 — prune to the inference subgraph, serialize
    the program + parameters.  The pruned program is statically verified
    before anything is written."""
    program = main_program or framework.default_main_program()
    target_names = [
        t.name if isinstance(t, framework.Variable) else t for t in target_vars
    ]
    pruned = _prune_program(program, list(feeded_var_names), target_names)
    _verify_io_program(
        pruned, list(feeded_var_names), target_names,
        "pruned inference program (save_inference_model would export a "
        "broken model)")
    os.makedirs(dirname, exist_ok=True)
    model_path = os.path.join(dirname, model_filename or "__model__.json")
    with open(model_path, "w") as f:
        f.write(pruned.to_json())
    meta = {"feed_names": list(feeded_var_names), "fetch_names": target_names}
    with open(os.path.join(dirname, "__meta__.pkl"), "wb") as f:
        pickle.dump(meta, f)
    save_vars(
        executor, dirname, pruned,
        predicate=lambda v: v.persistable and not v.is_data,
        filename=params_filename,
    )
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Returns [program, feed_names, fetch_vars] (reference signature)."""
    model_path = os.path.join(dirname, model_filename or "__model__.json")
    with open(model_path) as f:
        program = framework.Program.from_json(f.read())
    with open(os.path.join(dirname, "__meta__.pkl"), "rb") as f:
        meta = pickle.load(f)
    _verify_io_program(
        program, list(meta.get("feed_names", [])),
        list(meta.get("fetch_names", [])),
        "deserialized inference program %r" % model_path)
    load_vars(
        executor, dirname, program,
        predicate=lambda v: v.persistable and not v.is_data,
        filename=params_filename,
    )
    fetch_vars = [program.global_block.var(n) for n in meta["fetch_names"]]
    return [program, meta["feed_names"], fetch_vars]
