"""STARK-101's Fibonacci-square AIR: one column, a_{i+2} = a_{i+1}^2 +
a_i^2, from a_0 = 1 and the witness a_1; publics a_0 and the last
value."""

COLUMNS = 1
SHIFTS = (0, 1, 2)  # rows a query opens, from its index
ALPHAS = 3  # composition weights drawn
PROGRAM_AIR = ("FibonacciSquareAIR", "a1")  # class, witness keyword


def plain_trace(p: int, witness: int, rows: int) -> list[list[int]]:
    out, x, y = [], 1, witness % p
    for _ in range(rows):
        out.append(x)
        x, y = y, (x * x + y * y) % p
    return [out]


def publics(at) -> dict:
    """`at(column, row)` reads the trace."""
    return {"a0": at(0, 0), "a_last": at(0, -1)}


def terms(ctx) -> list:
    """The constraints, each divided by its vanishing polynomial, on the
    coset (``reference.stark.Composition``)."""
    f, c = ctx.f, ctx.c
    fx, fgx, fg2x = ctx.ldes[0], ctx.shifted(0, 1), ctx.shifted(0, 2)
    return [
        f.mul(f.sub(fx, c(ctx.publics["a0"])), ctx.inv_first),
        f.mul(f.sub(fx, c(ctx.publics["a_last"])), ctx.inv_last),
        f.mul(f.sub(f.sub(fg2x, f.mul(fgx, fgx)), f.mul(fx, fx)),
              ctx.transition(2))]
