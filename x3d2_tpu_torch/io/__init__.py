from .monitoring import Monitor, make_observables_fn
