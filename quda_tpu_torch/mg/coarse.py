"""The coarse stencil's directions, as in quda_tpu/mg/coarse.py.

The complex ``CoarseOperator`` and its probing construction belong to the
complex hierarchy, which is not ported (ROADMAP A12); the pair hierarchy
(mg/pair.py) has its own.
"""

DIRS = tuple((mu, sign) for mu in range(4) for sign in (+1, -1))
