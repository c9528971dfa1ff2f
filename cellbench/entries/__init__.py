"""Entry drivers, one module an entry of the port, named by a traffic
file's ``entry`` key.  Each has ``Entry(config, traffic, device)`` with
``run(item)``, and the module functions the harness calls around it."""
