"""
Row filters (the port of ``gordo_tpu.data.filter_rows``): a filter is an
expression over the tag columns, or a list of them ANDed, keeping the
rows where it holds; the JAX package evaluates it with pandas'
``DataFrame.eval``, the port with the small evaluator here.

The evaluator reads the part of pandas' ``eval`` language that configs
use, over numpy columns:

- column names, bare or backtick-quoted (```Tag A` > 5``), and numbers;
- ``+ - * / ** %`` and unary minus and plus;
- the comparisons ``< <= > >= == !=``, chained too (``1 < `a` < 5``);
- ``& | ~`` and ``and or not``, with pandas' precedence: ``&`` and ``|``
  bind as ``and`` and ``or`` do, below the comparisons;
- parentheses and ``abs(...)``.

Anything else raises ``ValueError`` naming the expression and the part
it refuses; nothing is ever passed to Python's ``eval``. A result that
is not boolean keeps the rows where it is non-zero, as pandas' ``astype
(bool)`` does. ``buffer_size`` also drops that many rows on each side of
every removed row (``apply_buffer``).
"""

import ast
import io
import operator
import re
import tokenize
from typing import Dict, List, Sequence, Union

import numpy as np

_BACKTICK = re.compile(r"`([^`]*)`")

_BINARY = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
    ast.Mod: operator.mod,
    ast.BitAnd: operator.and_,
    ast.BitOr: operator.or_,
}
_COMPARE = {
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
}


def _prepare(expression: str):
    """(Python source, {placeholder: column}): backticked names become
    placeholders, and ``&``/``|`` become ``and``/``or``, as pandas'
    preparser does, so they bind below the comparisons."""
    names: Dict[str, str] = {}

    def placeholder(match):
        key = f"__column_{len(names)}__"
        names[key] = match.group(1)
        return key

    source = _BACKTICK.sub(placeholder, expression)
    tokens = []
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            tok = tokenize.TokenInfo(tokenize.NAME, {"&": "and", "|": "or"}[tok.string],
                                     tok.start, tok.end, tok.line)
        tokens.append((tok.type, tok.string))
    return tokenize.untokenize(tokens), names


class _Evaluator:
    def __init__(self, expression: str, columns: Dict[str, np.ndarray], names: Dict[str, str]):
        self.expression = expression
        self.columns = columns
        self.names = names

    def refuse(self, node, what: str = None):
        part = what or type(node).__name__
        raise ValueError(
            f"row_filter {self.expression!r}: {part} is outside the expressions the port "
            "evaluates (column names, numbers, + - * / ** %, comparisons, & | ~, and/or/not, "
            "abs)"
        )

    def __call__(self, node):
        if isinstance(node, ast.Expression):
            return self(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or not isinstance(node.value, (int, float)):
                self.refuse(node, f"the constant {node.value!r}")
            return node.value
        if isinstance(node, ast.Name):
            name = self.names.get(node.id, node.id)
            if name not in self.columns:
                raise ValueError(
                    f"row_filter {self.expression!r}: no column {name!r}; the columns are "
                    f"{sorted(self.columns)}"
                )
            return self.columns[name]
        if isinstance(node, ast.BinOp) and type(node.op) in _BINARY:
            left, right = self(node.left), self(node.right)
            with np.errstate(divide="ignore", invalid="ignore"):
                return _BINARY[type(node.op)](left, right)
        if isinstance(node, ast.UnaryOp):
            value = self(node.operand)
            if isinstance(node.op, ast.USub):
                return -value
            if isinstance(node.op, ast.UAdd):
                return +value
            if isinstance(node.op, (ast.Not, ast.Invert)):
                return ~np.asarray(value, dtype=bool)
        if isinstance(node, ast.BoolOp):
            combine = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
            result = np.asarray(self(node.values[0]), dtype=bool)
            for value in node.values[1:]:
                result = combine(result, np.asarray(self(value), dtype=bool))
            return result
        if isinstance(node, ast.Compare) and all(type(op) in _COMPARE for op in node.ops):
            left = self(node.left)
            result = None
            for op, comparator in zip(node.ops, node.comparators):
                right = self(comparator)
                with np.errstate(invalid="ignore"):
                    step = _COMPARE[type(op)](left, right)
                result = step if result is None else result & step
                left = right
            return result
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "abs" and len(node.args) == 1 and not node.keywords):
            return np.abs(self(node.args[0]))
        self.refuse(node)


def evaluate(columns: Dict[str, np.ndarray], expression: str) -> np.ndarray:
    """The row mask of one expression over named numpy columns."""
    source, names = _prepare(expression)
    try:
        tree = ast.parse(source.strip(), mode="eval")
    except SyntaxError as err:
        raise ValueError(f"row_filter {expression!r} does not parse: {err.msg}") from None
    n_rows = len(next(iter(columns.values()))) if columns else 0
    result = _Evaluator(expression, columns, names)(tree)
    return np.broadcast_to(np.asarray(result).astype(bool), (n_rows,)).copy()


def apply_buffer(mask: np.ndarray, buffer_size: int = 0) -> np.ndarray:
    """The mask with every removed (False) row's ``buffer_size``
    neighbours on each side removed too."""
    if buffer_size == 0:
        return mask
    removed = ~np.asarray(mask, dtype=bool)
    kernel = np.ones(2 * buffer_size + 1, dtype=int)
    return ~(np.convolve(removed.astype(int), kernel, mode="same") > 0)


def filter_rows_mask(
    values: np.ndarray,
    column_names: Sequence[str],
    filter_str: Union[str, List[str]],
    buffer_size: int = 0,
) -> np.ndarray:
    """The rows of a (rows, columns) table that ``filter_str`` keeps (a
    list of expressions is ANDed), after the buffer."""
    columns = {name: values[:, j] for j, name in enumerate(column_names)}
    expressions = [filter_str] if isinstance(filter_str, str) else list(filter_str)
    mask = np.ones(len(values), dtype=bool)
    for expression in expressions:
        mask &= evaluate(columns, expression)
    return apply_buffer(mask, buffer_size)
