"""Symbol: declarative graph construction.

The graph IR is the JAX package's, node for node: nodes with typed attrs,
composition by substitution, bidirectional shape inference, and the
MXNet-style JSON wire format — a graph written by ``mxnet_tpu``'s
``tojson`` loads here and serializes back to the same JSON. Binding hands
the graph to ``executor.Executor``, which interprets it eagerly.

The operators build the JAX package's nodes: ``+ - * / **`` between
symbols (``_plus``, ``_minus``, ``_mul``, ``_div``, ``_power``) or with a
number (``_add_scalar`` ... ``_power_scalar``, the reflected
``_rsub_scalar`` / ``_rdiv_scalar``), unary ``-`` (``negative``); so does
every ``mx.sym.<op>`` and the module functions ``zeros``, ``ones``,
``arange``, ``pow``, ``maximum``, ``minimum`` and ``hypot``. A graph
built with them serializes to the JAX package's JSON node for node.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .base import (MXNetError, attr_to_str, str_to_attr, merge_shape,
                   shape_is_known)
from .context import current_context
from .ops.registry import OP_REGISTRY, get_op
from . import attribute, name as _name_mod

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "arange", "pow", "maximum", "minimum", "hypot"]


class Node:
    """One op instance (or variable) in the graph."""

    __slots__ = ("op", "name", "attrs", "inputs", "_extra")

    def __init__(self, op, name, attrs=None, inputs=None, extra=None):
        self.op = op                  # op name, or None for variables
        self.name = name
        self.attrs = attrs or {}      # typed op params
        self.inputs = inputs or []    # list of (Node, out_index)
        self._extra = extra or {}     # user attrs (__dtype__, ctx_group...)

    @property
    def is_variable(self):
        return self.op is None

    def opdef(self):
        return get_op(self.op)


class Symbol:
    """A set of output entries over the node graph."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(Node, int)]

    # ------------------------------------------------------------- graph walk
    def _topo_nodes(self):
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def _arg_nodes(self):
        return [n for n in self._topo_nodes()
                if n.is_variable and not n._extra.get("__is_aux__")]

    def _aux_nodes(self):
        return [n for n in self._topo_nodes()
                if n.is_variable and n._extra.get("__is_aux__")]

    # -------------------------------------------------------------- listings
    def list_arguments(self):
        return [n.name for n in self._arg_nodes()]

    def list_auxiliary_states(self):
        return [n.name for n in self._aux_nodes()]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
                continue
            onames = node.opdef().output_names(node.attrs)
            names.append(f"{node.name}_{onames[idx]}")
        return names

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    # ------------------------------------------------------------ attributes
    def attr(self, key):
        """The first output node's attribute ``key`` as a string: a user
        attribute, else an op parameter, else None."""
        node = self._outputs[0][0]
        val = node._extra.get(key)
        if val is None and key in node.attrs:
            return attr_to_str(node.attrs[key])
        return val

    # ------------------------------------------------------------- accessors
    def __getitem__(self, index):
        """One output, by position or by name (``list_outputs()``)."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError(f"no output named {index!r}")
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def get_internals(self):
        """A symbol over every output of every node, variables included,
        in topological order: ``get_internals()["<node>_output"]``."""
        outs = []
        for node in self._topo_nodes():
            if node.is_variable:
                outs.append((node, 0))
            else:
                outs.extend((node, i) for i in range(
                    node.opdef().num_outputs(node.attrs)))
        return Symbol(outs)

    def get_output(self, index):
        return self[index]

    # ------------------------------------------------------------ composition
    def __call__(self, *args, **kwargs):
        """Compose: substitute this symbol's free variables (positional
        args in list_arguments order, kwargs by variable name)."""
        arg_names = self.list_arguments()
        mapping = dict(zip(arg_names, args))
        mapping.update({k: v for k, v in kwargs.items() if k != "name"})
        for v in mapping.values():
            if not isinstance(v, Symbol):
                raise TypeError("compose expects Symbol arguments")
        return self._substitute(mapping)

    def _substitute(self, mapping):
        memo = {}

        def clone(node):
            if id(node) in memo:
                return memo[id(node)]
            if node.is_variable and node.name in mapping:
                result = mapping[node.name]._outputs[0]
                memo[id(node)] = result
                return result
            new = Node(node.op, node.name, dict(node.attrs), [],
                       dict(node._extra))
            memo[id(node)] = (new, None)
            fixed = []
            for inp, idx in node.inputs:
                cn, ci = clone(inp)
                fixed.append((cn, idx if ci is None else ci))
            new.inputs = fixed
            return (new, None)

        outs = []
        for node, idx in self._outputs:
            cn, ci = clone(node)
            outs.append((cn, idx if ci is None else ci))
        return Symbol(outs)

    # ------------------------------------------------------------ arithmetic
    def _binary_op(self, other, opname, scalar_op):
        if isinstance(other, Symbol):
            return _create(opname, [self, other])
        if isinstance(other, (int, float, np.generic)):
            return _create(scalar_op, [self], scalar=float(other))
        return NotImplemented

    def __add__(self, o): return self._binary_op(o, "_plus", "_add_scalar")
    __radd__ = __add__
    def __sub__(self, o): return self._binary_op(o, "_minus", "_sub_scalar")

    def __rsub__(self, o):
        return _create("_rsub_scalar", [self], scalar=float(o))

    def __mul__(self, o): return self._binary_op(o, "_mul", "_mul_scalar")
    __rmul__ = __mul__
    def __truediv__(self, o): return self._binary_op(o, "_div", "_div_scalar")
    __div__ = __truediv__

    def __rtruediv__(self, o):
        return _create("_rdiv_scalar", [self], scalar=float(o))
    __rdiv__ = __rtruediv__

    def __pow__(self, o): return self._binary_op(o, "_power", "_power_scalar")
    def __neg__(self): return _create("negative", [self])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __repr__(self):
        name = self.name
        return f"<Symbol {name if name else 'Grouped'}>"

    # -------------------------------------------------------------- inference
    def infer_shape(self, *args, **kwargs):
        """Bidirectional shape inference: (arg_shapes, out_shapes,
        aux_shapes) in listing order; raises when an argument stays
        unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        for nm, s in zip(arg_names, args):
            if s is not None:
                known[nm] = tuple(s)
        for k, v in kwargs.items():
            known[k] = tuple(v)
        shapes = self._infer_entry_shapes(known)

        def _final(s):
            if s is None or 0 in s:
                return None if not partial else s
            return s

        arg_shapes = [_final(shapes[id(n)][0]) for n in self._arg_nodes()]
        aux_shapes = [_final(shapes[id(n)][0]) for n in self._aux_nodes()]
        out_shapes = [_final(shapes[id(n)][i]) for n, i in self._outputs]
        if not partial and any(s is None for s in arg_shapes):
            missing = [nm for nm, s in zip(arg_names, arg_shapes)
                       if s is None]
            raise MXNetError(f"cannot infer shapes for arguments {missing}; "
                             "provide more input shapes")
        return arg_shapes, out_shapes, aux_shapes

    def _infer_entry_shapes(self, known):
        """Fixpoint pass core: returns {id(node): [partial out shapes]}."""
        nodes = self._topo_nodes()
        shapes = {}
        for node in nodes:
            if node.is_variable:
                seed = known.get(node.name)
                if seed is None and "__shape__" in node._extra:
                    hint = str_to_attr(node._extra["__shape__"])
                    if isinstance(hint, (tuple, list)):
                        seed = tuple(int(d) for d in hint)
                shapes[id(node)] = [seed]
            else:
                shapes[id(node)] = [None] * node.opdef().num_outputs(
                    node.attrs)

        for _ in range(4):  # fixpoint iterations
            changed = False
            for node in nodes:
                if node.is_variable:
                    continue
                in_entries = [(shapes[id(inp)], idx)
                              for inp, idx in node.inputs]
                in_shapes = [store[idx] for store, idx in in_entries]
                new_in, out_shapes, _aux = _infer_node_shape(
                    node.opdef(), node, in_shapes,
                    out_known=list(shapes[id(node)]))
                try:
                    for (store, idx), s in zip(in_entries, new_in):
                        merged = merge_shape(store[idx], s)
                        if merged != store[idx]:
                            store[idx] = merged
                            changed = True
                    store = shapes[id(node)]
                    for i, s in enumerate(out_shapes[:len(store)]):
                        merged = merge_shape(store[i], s)
                        if merged != store[i]:
                            store[i] = merged
                            changed = True
                except MXNetError as e:
                    raise MXNetError(
                        f"infer_shape mismatch at "
                        f"{_node_provenance(node, in_shapes)}: {e}") from e
            if not changed:
                break
        return shapes

    def infer_type(self, *args, **kwargs):
        """Type inference: float32 propagation, declared aux dtypes kept."""
        arg_names = self.list_arguments()
        known = {nm: np.dtype(t) for nm, t in zip(arg_names, args)
                 if t is not None}
        known.update({k: np.dtype(v) for k, v in kwargs.items()})
        default = next(iter(known.values())) if known \
            else np.dtype("float32")
        arg_types = [known.get(nm, default) for nm in arg_names]
        out_types = [default] * len(self._outputs)
        aux_types = [n._extra.get("__dtype__", "float32")
                     for n in self._aux_nodes()]
        return arg_types, out_types, aux_types

    # ----------------------------------------------------------- serialization
    def tojson(self):
        """MXNet-style JSON graph: nodes + arg_nodes + heads."""
        nodes = self._topo_nodes()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jn = {
                "op": "null" if n.is_variable else n.op,
                "name": n.name,
                "inputs": [[node_ids[id(inp)], idx, 0]
                           for inp, idx in n.inputs],
            }
            attrs = {k: attr_to_str(v) for k, v in n.attrs.items()}
            attrs.update({k: str(v) for k, v in n._extra.items()})
            if attrs:
                jn["attrs"] = attrs
            jnodes.append(jn)
        arg_nodes = [node_ids[id(n)] for n in nodes if n.is_variable]
        heads = [[node_ids[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": [], "heads": heads,
                           "attrs": {"mxnet_version": ["int", 905]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # ----------------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **kwargs):
        """Bind with zero-filled cells of the given shapes (and a zero
        gradient cell per argument whose ``grad_req`` is not "null")."""
        from .executor import Executor
        return Executor.simple_bind(self, ctx or current_context(),
                                    type_dict, kwargs, grad_req)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """Bind over caller-provided argument / gradient / aux cells."""
        from .executor import Executor
        return Executor(self, ctx or current_context(), args, args_grad,
                        grad_req, aux_states)

    def eval(self, ctx=None, **kwargs):
        """Bind on ``ctx`` with the given arrays' shapes, no gradients, and
        run one inference forward on them; returns the outputs."""
        ex = self.simple_bind(ctx=ctx or current_context(), grad_req="null",
                              **{k: v.shape for k, v in kwargs.items()})
        return ex.forward(is_train=False, **kwargs)

    def attr_dict(self):
        """{node name: {attr: str}} for every node with attributes (op
        params and user attrs such as ``__lr_mult__``)."""
        ret = {}
        for node in self._topo_nodes():
            d = {k: attr_to_str(v) for k, v in node.attrs.items()}
            d.update({k: v for k, v in node._extra.items()
                      if not k.startswith("__is_aux__")})
            if d:
                ret[node.name] = d
        return ret


def _node_provenance(node, in_shapes=None):
    """'op X node Y (inputs: a=(2, 3), b=?)' for inference errors."""
    parts = []
    for i, (inp, idx) in enumerate(node.inputs):
        nm = inp.name if inp.is_variable else f"{inp.name}[{idx}]"
        s = in_shapes[i] if in_shapes is not None and i < len(in_shapes) \
            else None
        parts.append(f"{nm}={s if s is not None else '?'}")
    inputs = f" (inputs: {', '.join(parts)})" if parts else ""
    return f"op {node.op!r} node {node.name!r}{inputs}"


def _infer_node_shape(opdef, node, in_shapes, out_known=None):
    aux_count = len(opdef.aux_names(node.attrs))
    regular = in_shapes[:len(in_shapes) - aux_count] if aux_count \
        else in_shapes
    n_out = opdef.num_outputs(node.attrs)
    if opdef.infer_shape is not None:
        try:
            if opdef._infer_accepts_out:
                new_in, outs, auxs = opdef.infer_shape(
                    node.attrs, regular, out_known)
            else:
                new_in, outs, auxs = opdef.infer_shape(node.attrs, regular)
        except (KeyError, IndexError, TypeError):
            # incomplete information inside the infer fn: unknown for now
            return in_shapes, [None] * n_out, []
        except (ValueError, MXNetError) as e:
            raise MXNetError(
                f"infer_shape failed at "
                f"{_node_provenance(node, in_shapes)}: {e}") from e
        return list(new_in) + list(auxs), outs, auxs
    if opdef.shape_passthrough:
        merged = regular[0] if regular else None
        for s in (out_known or []):
            merged = merge_shape(merged, s)
        return [merged] + list(in_shapes[1:]), [merged] * n_out, []
    # abstract evaluation: the plain forward on meta tensors (shapes only,
    # no storage, no device) — needs every input shape
    if any(not shape_is_known(s) for s in in_shapes):
        return in_shapes, [None] * n_out, []
    dummies = [torch.empty(tuple(s), device="meta") for s in in_shapes]
    reg = dummies[:len(dummies) - aux_count] if aux_count else dummies
    aux = dummies[len(dummies) - aux_count:] if aux_count else []
    try:
        outs, _ = opdef.forward(node.attrs, reg, aux, False, None)
    except (RuntimeError, ValueError, IndexError) as e:
        raise MXNetError(
            f"shape inference (abstract evaluation) failed at "
            f"{_node_provenance(node, in_shapes)}: {e}") from e
    return in_shapes, [tuple(o.shape) for o in outs], []


# ------------------------------------------------------------------ factories
def var(name, attr=None, shape=None, dtype=None, **kwargs):
    """Create a variable symbol."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    extra = attribute.current_attrs(attr)
    extra = dict(extra) if extra else {}
    if dtype is not None:
        extra["__dtype__"] = str(np.dtype(dtype))
    if shape is not None:
        extra["__shape__"] = str(tuple(shape))
    extra.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(Node(None, name, extra=extra), 0)])


Variable = var


def Group(symbols):
    """Group symbols into one multi-output symbol."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load_json(json_str):
    data = json.loads(json_str)
    built = []
    for jn in data["nodes"]:
        # legacy key spellings: op params in "param", user attrs in "attr"
        attrs_raw = {}
        for key in ("param", "attr", "attrs"):
            attrs_raw.update(jn.get(key) or {})
        op = jn["op"]
        if op == "null":
            node = Node(None, jn["name"], extra=dict(attrs_raw))
            if attrs_raw.get("__is_aux__") == "True":
                node._extra["__is_aux__"] = True
        else:
            opdef = get_op(op)
            reserved = {"ctx_group", "lr_mult", "wd_mult"}
            attrs = opdef.normalize_attrs(
                {k: str_to_attr(v) for k, v in attrs_raw.items()
                 if not k.startswith("__") and k not in reserved})
            extra = {k: v for k, v in attrs_raw.items()
                     if k.startswith("__") or k in reserved}
            node = Node(op, jn["name"], attrs, extra=extra)
        node.inputs = [(built[i], oi) for i, oi, *_ in jn["inputs"]]
        built.append(node)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    # restore aux marking from op aux slots
    for node in built:
        if node.is_variable:
            continue
        aux_n = len(get_op(node.op).aux_names(node.attrs))
        if aux_n:
            for inp, _ in node.inputs[len(node.inputs) - aux_n:]:
                if inp.is_variable:
                    inp._extra["__is_aux__"] = True
    return Symbol([(built[i], oi) for i, oi, *_ in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------- op creation
def _create(op_name, input_syms, name=None, attr=None, **params):
    """Build a Symbol node for a registered op."""
    opdef = get_op(op_name)
    attrs = opdef.normalize_attrs(params)
    node_name = _name_mod.current().get(name, op_name.strip("_"))
    extra = attribute.current_attrs(attr)
    extra = dict(extra) if extra else {}

    inputs = []
    for i, inm in enumerate(opdef.input_names(attrs)):
        if i < len(input_syms) and input_syms[i] is not None:
            s = input_syms[i]
            if len(s._outputs) != 1:
                raise MXNetError(
                    f"op {op_name} input {inm} must be single-output")
            inputs.append(s._outputs[0])
        else:
            # auto-create missing weight/bias variables
            inputs.append((Node(None, f"{node_name}_{inm}",
                                extra=dict(extra)), 0))
    for anm in opdef.aux_names(attrs):
        aux_extra = {**extra, "__is_aux__": True}
        # a declared non-f32 aux cell (the int32 cache cursor) is stamped
        # onto the variable so binding honors it
        adt = opdef.aux_dtypes.get(anm)
        if callable(adt):
            adt = adt(attrs or {})
        if adt is not None:
            # a name as it is (numpy knows no float8 without ml_dtypes)
            aux_extra["__dtype__"] = adt if isinstance(adt, str) \
                else str(np.dtype(adt))
        inputs.append((Node(None, f"{node_name}_{anm}", extra=aux_extra), 0))

    node = Node(op_name, node_name, attrs, inputs, extra)
    return Symbol([(node, i)
                   for i in range(opdef.num_visible_outputs(attrs))])


def _make_symbol_function(op_name):
    opdef = get_op(op_name)

    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        params = {k: v for k, v in kwargs.items()
                  if not isinstance(v, Symbol)}
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, Symbol)}
        input_syms = list(args)
        if sym_kwargs:
            in_names = opdef.input_names(opdef.normalize_attrs(params))
            by_name = [None] * len(in_names)
            for i, s in enumerate(input_syms):
                by_name[i] = s
            for k, v in sym_kwargs.items():
                if k not in in_names:
                    raise TypeError(f"{op_name}: no input named {k!r}")
                by_name[in_names.index(k)] = v
            input_syms = by_name
        # a variadic op (Concat) counts its inputs when not told
        if callable(opdef._inputs) and "num_args" in opdef.attr_spec and \
                "num_args" not in params:
            params["num_args"] = len([s for s in input_syms
                                      if s is not None]) or len(args)
        return _create(op_name, input_syms, name=name, attr=attr, **params)

    creator.__name__ = op_name
    creator.__doc__ = f"symbolic {op_name}"
    return creator


def _init_symbol_module(module_dict):
    """Auto-generate mx.sym.<op> functions from the registry."""
    for op_name in list(OP_REGISTRY):
        module_dict[op_name] = _make_symbol_function(op_name)


def zeros(shape, dtype=None, name=None):
    return _create("_zeros", [], name=name, shape=shape,
                   dtype=str(np.dtype(dtype or "float32")))


def ones(shape, dtype=None, name=None):
    return _create("_ones", [], name=name, shape=shape,
                   dtype=str(np.dtype(dtype or "float32")))


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, name=None):
    return _create("_arange", [], name=name, start=start, stop=stop,
                   step=step, repeat=repeat,
                   dtype=str(np.dtype(dtype or "float32")))


def _sym_scalar_dispatch(both, lscalar, rscalar, pyfn, name):
    """``name(left, right)`` over Symbol / number operands: the op
    ``both`` between symbols, ``lscalar`` / ``rscalar`` with a number on
    the right / left (the ops ``mx.sym`` gains at import), ``pyfn`` on two
    numbers."""
    def fn(left, right):
        g = globals()
        if isinstance(left, Symbol) and isinstance(right, Symbol):
            return g[both](left, right)
        if isinstance(left, Symbol):
            return g[lscalar](left, scalar=float(right))
        if isinstance(right, Symbol):
            return g[rscalar](right, scalar=float(left))
        return pyfn(left, right)
    fn.__name__ = name
    return fn


pow = _sym_scalar_dispatch("_power", "_power_scalar", "_rpower_scalar",
                           lambda a, b: a ** b, "pow")
maximum = _sym_scalar_dispatch("_maximum", "_maximum_scalar",
                               "_maximum_scalar",
                               lambda a, b: a if a > b else b, "maximum")
minimum = _sym_scalar_dispatch("_minimum", "_minimum_scalar",
                               "_minimum_scalar",
                               lambda a, b: a if a < b else b, "minimum")
hypot = _sym_scalar_dispatch("_hypot", "_hypot_scalar", "_hypot_scalar",
                             lambda a, b: float(np.hypot(a, b)), "hypot")
