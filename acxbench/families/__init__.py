"""One adapter per model family: how a configuration file becomes the
port's config, which port module serves it, how the benchmark draws its
weights, and which plain reference computes it. A configuration names its
family by the file's ``family`` key."""
