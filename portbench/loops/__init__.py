"""Dispatch loops, one module a kind of traffic (``<loop>.py``, named by
a traffic file's ``"loop"``). Each defines ``Loop(cell)``: it builds the
cell's ring of inputs on the device from the seed, and has ``run``
(dispatch for a number of seconds, or a number of calls), ``outputs``
(what the last pass over the ring handed to the host), ``control``
(the same from the reference in the precision below the configured
one) and ``check`` (the numbers compared with the reference)."""
