"""The benchmark's own code: traffic generation, the mappings it hands
the program, the judge, the reduction of spans and traces to metrics."""
