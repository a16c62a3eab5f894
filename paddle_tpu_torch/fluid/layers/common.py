"""Shared helpers for layer functions (counterpart of
`paddle_tpu/fluid/layers/common.py`, static mode)."""

from ..layer_helper import LayerHelper


def to_var_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def append_simple_op(op_type, inputs, attrs=None, out_slots=("Out",), dtype=None,
                     stop_gradient=False, n_outs=None):
    """Append a one-op layer; inputs maps slot -> Variable or [Variable].

    Returns a single Variable when out_slots == ("Out",) (or single slot),
    else a tuple ordered by out_slots.
    """
    helper = LayerHelper(op_type)
    in_names = {}
    ref_var = None
    for slot, vs in inputs.items():
        vs = to_var_list(vs)
        if not vs:
            continue
        in_names[slot] = [v.name for v in vs]
        if ref_var is None:
            ref_var = vs[0]
    out_vars = {}
    block = helper.main_program.current_block()
    for slot in out_slots:
        cnt = (n_outs or {}).get(slot, 1)
        out_vars[slot] = [
            helper.create_variable_for_type_inference(
                dtype or (ref_var.dtype if ref_var is not None else "float32"),
                stop_gradient=stop_gradient,
            )
            for _ in range(cnt)
        ]
    helper.append_op(
        op_type,
        inputs=in_names,
        outputs={slot: [v.name for v in vs] for slot, vs in out_vars.items()},
        attrs=attrs or {},
    )
    results = []
    for slot in out_slots:
        vs = [block.var(v.name) for v in out_vars[slot]]  # shapes inferred
        results.append(vs if len(vs) > 1 else vs[0])
    return results[0] if len(results) == 1 else tuple(results)
