"""Models of the port: DLRM (serving head and training forward) and the
blockwise attention the attention kernel's backward recomputes through."""
