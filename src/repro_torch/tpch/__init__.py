"""TPC-H on the port: schema, generator, oracles, IR queries, driver."""
