"""The harness: the spec's files, the import guard, clocks and spans, the
device trace, the comparison and the result line."""
