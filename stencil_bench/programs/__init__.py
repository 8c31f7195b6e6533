"""The programs a cell can run, one adapter a file: a configuration's
`program` key names stencil_bench/programs/<program>.py, which the
finder (registry.program) loads by path. An adapter brings its own
inputs and its own plain reference, and holds

    class Program(rank, config, traffic, device)
        facts            dict: global_shape, local_shape, coords, dims,
                         itemsize, steps_per_run (what the metric readers read)
        set_seed(seed)   make the seed's inputs on the device
        run()            one run of the timed path from the seed's inputs
        output()         the last run's result, which stays valid after release()
        loop_facts()     dict: route, q, capture_s, launches (for the notes
                         and the readers)
        release()        free the program's state, graphs and caches
        readings(out)    the reference from the seed's inputs, and `out`
                         held against it: a dict of plain numbers
        control_output() the reference in the precision below the
                         configuration's, put in the program's place

    checks(config, per_rank) -> {name: {"value", "limit"}}

so that a later program adds a file here and a configuration naming it,
and edits no file that is there.
"""
