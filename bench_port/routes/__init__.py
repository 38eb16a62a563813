"""Entries of the port that a cell drives, one module a route
(routes/<route>.py), each with a `Route` class (see harness.Route)."""
