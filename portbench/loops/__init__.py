"""The general generators, one a traffic ``kind``: each reads its traffic
file's parameters and drives a system's entry."""
