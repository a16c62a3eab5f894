"""LayerHelper: shared parameter/var creation machinery for layers.

Counterpart of `paddle_tpu/fluid/layer_helper.py`, static mode only:
creates Parameters in BOTH the startup program (with their init op) and
the main program, creates temp output vars, applies act/bias.
"""

from . import framework, initializer, unique_name


class ParamAttr:
    """cf. reference param_attr.py:ParamAttr."""

    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        do_model_average=False,
        need_clip=True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, initializer.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError("bad ParamAttr: %r" % (attr,))


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type

    @property
    def name(self):
        return self.kwargs.get("name") or unique_name.generate(self.layer_type)

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    def create_parameter(
        self, attr, shape, dtype="float32", is_bias=False, default_initializer=None
    ):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer
        if init is None:
            init = (
                initializer._global_bias_initializer()
                if is_bias
                else initializer._global_weight_initializer()
            )
        name = attr.name or unique_name.generate(self.layer_type + ".w")
        kw = dict(
            dtype=dtype,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
            need_clip=attr.need_clip,
        )
        # startup side: param var + its init op
        sp = self.startup_program.global_block.create_parameter(
            name, shape, **kw)
        init(sp, self.startup_program.global_block)
        # main side: same param var (no init op)
        return self.main_program.global_block.create_parameter(
            name, shape, **kw)

    def create_variable_for_type_inference(self, dtype="float32", stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(self.layer_type + ".tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(
            type, inputs=inputs, outputs=outputs, attrs=attrs
        )

    def append_activation(self, out, act):
        if act is None:
            return out
        res = self.create_variable_for_type_inference(out.dtype)
        self.append_op(act, inputs={"X": [out.name]}, outputs={"Out": [res.name]})
        return self.main_program.current_block().var(res.name)

    def append_bias_op(self, out, bias, axis=1):
        if bias is None:
            return out
        res = self.create_variable_for_type_inference(out.dtype)
        self.append_op(
            "elementwise_add",
            inputs={"X": [out.name], "Y": [bias.name]},
            outputs={"Out": [res.name]},
            attrs={"axis": axis},
        )
        return self.main_program.current_block().var(res.name)
