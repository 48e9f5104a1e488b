"""Reference engine `plain` (the default): `rtbench.ref.engine.RefEngine`,
the port's plain twins frozen, the records worked out from the scene."""

from rtbench.ref.engine import RefEngine as Engine  # noqa: F401
