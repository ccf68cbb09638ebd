"""The benchmark's harness: cell lookup, the configuration's family, inputs
drawn from the seed, the closed-loop clients, the measured window, the
trace, the outputs check and the result line."""
