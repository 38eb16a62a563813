"""Plain references, one module a route (reference/<route>.py): plain
torch and numpy that import nothing of the port, each with
`expected(corpus, params, device)` and `compare(answer, expected)`."""
