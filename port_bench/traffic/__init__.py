"""One module a traffic kind; the harness loads ``traffic/<kind>.py`` by name."""
