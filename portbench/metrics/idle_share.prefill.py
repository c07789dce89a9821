"""Percent of the traced stretch in which no kernel, copy or memset ran on
the device."""
from portbench.lib.readers import idle_share as read  # noqa: F401
