"""One module per entry kind, named by a traffic file's ``entry``.

Each defines ``Cell(config, traffic, seed, device)`` with:

* ``setup()``: the seeded weights and inputs, the program's objects, every
  shape the window uses warmed (and, for training, the checked first steps);
* ``unit() -> int``: one timed unit of work, returning the units it counts
  (frames or pairs); ``model_flops(units)``: the model FLOP of that many;
* ``release()``: frees the program's state once the window has closed;
* ``check() -> list of (name, value)``: the numbers compared with the
  reference, each against the limit of the same name in the cell's limits
  file.
"""
