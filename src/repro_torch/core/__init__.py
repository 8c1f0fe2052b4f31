"""The port's planner (the reference's modules, copied) and its executor."""
